"""PyTorch + CUDA port of the SLAY stack for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and names. Plain tensor code is PyTorch; the Pallas kernels
on the serving path are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Entry points take ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions. The
trainer and the serving engines take ``mesh=`` (``launch.mesh``), a
``DeviceMesh`` over ranks of a ``torch.distributed`` group, and then
shard by ``distributed.sharding``'s rules. Nothing here imports ``jax``
or ``repro``.
"""
