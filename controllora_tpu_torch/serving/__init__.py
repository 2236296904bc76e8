from controllora_tpu_torch.serving.engine import BatchingEngine, Request  # noqa: F401
