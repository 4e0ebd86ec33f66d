from lanczosplusplus_tpu_torch.symmetry.blocks import (  # noqa: F401
    DefaultSymmetry, ReflectionSymmetry, TranslationSymmetry, build_symmetry)
