"""Ops of the port: plain PyTorch compositions and the hand-written kernels.

Every kernel wrapper counts its launches in ``<wrapper>.launches``;
:data:`KERNELS` lists them by name.
"""

from simxns_tpu_torch.ops.flash_attention import (bh_attention_bwd,
                                                  bh_attention_fwd,
                                                  group_attention_bwd,
                                                  group_attention_fwd)
from simxns_tpu_torch.ops.fused_ffn import (ffn_bwd_dw, ffn_bwd_dx,
                                            ffn_fused_fwd, ffn_train_fwd,
                                            int8_dense_fwd, int8_ffn_fwd)
from simxns_tpu_torch.ops.fused_layer import (int8_linear, row_quant,
                                              small_s_attention)
from simxns_tpu_torch.ops.mips_kernel import mips_bucket_candidates

KERNELS = {
    "int8_linear": int8_linear,
    "row_quant": row_quant,
    "small_s_attention": small_s_attention,
    "mips_bucket_candidates": mips_bucket_candidates,
    "group_attention_fwd": group_attention_fwd,
    "group_attention_bwd": group_attention_bwd,
    "bh_attention_fwd": bh_attention_fwd,
    "bh_attention_bwd": bh_attention_bwd,
    "ffn_train_fwd": ffn_train_fwd,
    "ffn_bwd_dx": ffn_bwd_dx,
    "ffn_bwd_dw": ffn_bwd_dw,
    "ffn_fused_fwd": ffn_fused_fwd,
    "int8_dense": int8_dense_fwd,
    "int8_ffn": int8_ffn_fwd,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
