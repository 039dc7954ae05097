"""K1, the int8 GEMM with the dequantizing epilogue (the four products
of each encoder layer: q, k and v as one, the output projection, the
FFN's two), against its roofline over the encode window: each launch's
larger of int8 operations at 1,979 TOP/s and bytes at 3.35 TB/s (int8
operands, f32 scales and bias, q, k, v written in bf16 and the others in
f32), over the device time of the GEMM kernels (``gemm_kernel`` with the
dequantize epilogue, template argument 0; the encode runs no other).
Moves ``encode_passages_per_s``."""

import re

from benchmark import work

_K1 = re.compile(r"gemm_kernel<\s*\d+,\s*\d+,\s*0\s*,|gemm_kernelILi\d+ELi\d+ELi0E")


def read(view):
    seconds = view.kernel_seconds(lambda n: _K1.search(n) is not None)
    tokens = view.work.get("tokens", 0)
    if not seconds or not tokens:
        return None
    c = view.cell.config["retriever"]
    chunk = view.work["chunk_tokens"]
    least = work.encoder_int8_linear_work(c, chunk)["least_s"]
    return 100.0 * least * (tokens / chunk) / seconds
