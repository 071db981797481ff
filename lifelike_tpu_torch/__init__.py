"""lifelike_tpu_torch — the PyTorch/CUDA port of lifelike_tpu.

Same sub-package layout and names as ``lifelike_tpu`` (the JAX reference,
which this package never imports). Plain tensor code is PyTorch; the fused
MPPI candidate rollout is a hand-written CUDA kernel (``csrc/``, bound by
``ops/rollout_cuda.py``).

Entry points take an explicit ``device`` (default ``"cuda"``) and ``dtype``
and raise when no card is present unless the caller passes ``device="cpu"``.
"""
