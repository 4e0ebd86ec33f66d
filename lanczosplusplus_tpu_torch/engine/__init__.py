from lanczosplusplus_tpu_torch.engine.engine import Engine  # noqa: F401
