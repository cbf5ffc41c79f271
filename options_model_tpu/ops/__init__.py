"""Hot-path operators: engine selection, the fused GPU kernel and the LSM basis.

The native compute layer of the framework (SURVEY.md §2.3): where the reference
leaned on vendored NumPy/PyTorch kernels, this package provides the engine
switch (engine.py), the fused Heston Euler terminal kernel for NVIDIA GPUs
(triton_heston.py; its plain-XLA reference is models/heston.py, which it
reproduces draw for draw) and the LSM feature basis.
"""

from options_model_tpu.ops.lsm_basis import regression_features, NUM_FEATURES

__all__ = ["regression_features", "NUM_FEATURES"]
