from lanczosplusplus_tpu_torch.geometry.geometry import Geometry  # noqa: F401
