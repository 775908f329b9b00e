"""SynergAI on PyTorch and CUDA for an NVIDIA H100.

The counterpart of the JAX package ``repro``, module for module.  The host
layer (offline characterization, workloads, the discrete-event simulator and
the SynergAI policy) is the same numpy code; what the JAX package runs as
Pallas kernels (the scoring step, attention, the RWKV scan) runs here as CUDA
C++ kernels for ``sm_90a`` (``repro_torch.kernels``), the flash attention
kernel with a backward kernel for training (``repro_torch.training``).
Entry points run on the card unless the caller asks for ``device="cpu"``.
"""
