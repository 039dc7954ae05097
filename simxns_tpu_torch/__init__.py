"""simxns_tpu_torch: the SimXNS dense-retrieval engine in PyTorch for Hopper.

A port of :mod:`simxns_tpu` (JAX/flax/Pallas for a TPU) to PyTorch and
CUDA on an NVIDIA H100. The JAX package stays the numerical reference; this
package imports neither it nor JAX.

Ported so far: the serving path — tokenize, encode with the BERT dual
encoder (``layer_impl="fused_int8"`` runs on hand-written Hopper kernels),
build a device-resident MIPS index (bf16/f32 or int8 store), and search it
with the fused bucket top-k kernel (:class:`serve.DenseRetriever`); and the
AR2 training steps (:mod:`train`: DE warm-up, the cross-encoder reranker
on the grouped attention kernels, the AR2 retriever step with the int8
teacher view, AdamW).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every kernel wrapper launches its kernel for a CUDA tensor and takes its
plain PyTorch version only for a CPU tensor.
"""

from simxns_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
