"""The demo apps of the port (counterparts of ``apps/``): ``canny2image`` over the
stdlib web UI (``webui``)."""
