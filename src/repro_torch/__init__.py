"""SynergAI on PyTorch and CUDA for an NVIDIA H100.

The counterpart of the JAX package ``repro``, module for module.  The host
layer (offline characterization, workloads, the discrete-event simulator and
the SynergAI policy) is the same numpy code; the scoring step that the JAX
package runs as Pallas kernels runs here as CUDA C++ kernels for ``sm_90a``
(``repro_torch.kernels``).  Entry points run on the card unless the caller
asks for ``device="cpu"``.
"""
