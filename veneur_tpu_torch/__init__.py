"""veneur_tpu_torch: the PyTorch/CUDA port of veneur_tpu.

The same DogStatsD and SSF aggregation server, with its device state held in
torch tensors and its t-digest flush kernels written by hand in CUDA C++
for Hopper (``csrc/tdigest_merge.cu``). Module paths mirror
``veneur_tpu`` so each counterpart is easy to find. The package imports
neither ``jax`` nor anything of ``veneur_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
see :func:`veneur_tpu_torch.device.resolve_device`.
"""

__version__ = "0.1.0"
