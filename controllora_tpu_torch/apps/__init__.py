"""The demo apps of the port (counterparts of ``apps/``): ``canny2image`` and
``pose2image`` over the stdlib web UI (``webui``)."""
