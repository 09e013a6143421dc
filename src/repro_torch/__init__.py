"""WikiKV on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro``: the counterpart of ``repro/x/y.py`` is
``repro_torch/x/y.py``.  The package imports torch and numpy and nothing
of JAX or of ``repro``; the JAX-free host tier is kept as its own copy.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).  The device hot path goes through
hand-written Hopper kernels in ``repro_torch.kernels``.
"""
