"""PyTorch/CUDA port of the ASR-KF-EGR serving stack (``repro``).

The package mirrors ``repro``'s module layout (``configs``, ``models``,
``core``, ``kernels``, ``serving``, ``launch``) and keeps its array
layouts at every public function, so tests can hold each function against
its JAX counterpart.  It imports torch, numpy and the standard library
only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
