"""Kernels written by hand for Hopper, one module per Pallas file of the JAX
package (``incubator_mxnet_tpu/ops/pallas/``), with their plain versions and
launch counts. The CUDA sources are in ``incubator_mxnet_tpu_torch/csrc/``
and are built at first use by ``_build``."""

from .flash_attention import (flash_attention, flash_attention_backward,
                              flash_attention_backward_reference,
                              flash_attention_bwd_dkv,
                              flash_attention_bwd_dkv_bf16,
                              flash_attention_bwd_dkv_dbias,
                              flash_attention_bwd_dkv_dbias_bf16,
                              flash_attention_bwd_dkv_dbias_f16,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_dkv_f16,
                              flash_attention_bwd_dq_bf16,
                              flash_attention_bwd_dq_f16,
                              flash_attention_forward,
                              flash_attention_fwd_bf16,
                              flash_attention_fwd_f16,
                              flash_attention_reference)
from .flash_decode import (paged_causal_attention, paged_flash_decode,
                           paged_flash_decode_bf16,
                           paged_flash_decode_f16,
                           paged_flash_decode_reference)
from .fused_bottleneck import bottleneck_reference, fused_bottleneck
from .fused_norm import (layer_norm, layer_norm_bf16, layer_norm_f16,
                         layer_norm_reference, softmax, softmax_bf16,
                         softmax_f16, softmax_reference)
from .int8_matmul import (int8_matmul, int8_matmul_nk,
                          int8_matmul_nk_reference, int8_matmul_reference)
from .fused_optim import (fused_adam_flat, fused_adam_flat_bf16,
                          fused_adam_flat_f16,
                          fused_adam_flat_reference, fused_adamw_flat,
                          fused_adamw_flat_bf16, fused_adamw_flat_f16,
                          fused_adamw_flat_reference,
                          fused_sgd_mom_flat, fused_sgd_mom_flat_bf16,
                          fused_sgd_mom_flat_f16,
                          fused_sgd_mom_flat_reference,
                          multi_trainer_adam, multi_trainer_adam_reference,
                          multi_trainer_sgd_mom,
                          multi_trainer_sgd_mom_reference)

__all__ = ["bottleneck_reference", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_dbias", "flash_attention_bwd_dkv_bf16",
           "flash_attention_bwd_dkv_dbias_bf16", "paged_flash_decode_bf16",
           "flash_attention_bwd_dq_bf16", "flash_attention_fwd_bf16",
           "flash_attention_bwd_dq_f16", "flash_attention_bwd_dkv_f16",
           "flash_attention_fwd_f16", "layer_norm_f16", "softmax_f16",
           "flash_attention_bwd_dkv_dbias_f16", "paged_flash_decode_f16",
           "fused_adam_flat_bf16",
           "fused_adamw_flat_bf16", "fused_sgd_mom_flat_bf16",
           "fused_adam_flat_f16", "fused_adamw_flat_f16",
           "fused_sgd_mom_flat_f16",
           "flash_attention_bwd_dq", "flash_attention_forward",
           "flash_attention_reference", "fused_adam_flat",
           "int8_matmul", "int8_matmul_nk", "int8_matmul_nk_reference",
           "int8_matmul_reference",
           "fused_adam_flat_reference", "fused_adamw_flat",
           "fused_adamw_flat_reference", "fused_bottleneck",
           "fused_sgd_mom_flat", "fused_sgd_mom_flat_reference",
           "layer_norm", "layer_norm_bf16",
           "layer_norm_reference", "multi_trainer_adam",
           "multi_trainer_adam_reference", "multi_trainer_sgd_mom",
           "multi_trainer_sgd_mom_reference",
           "paged_causal_attention", "paged_flash_decode",
           "paged_flash_decode_reference", "softmax", "softmax_bf16", "softmax_reference",
           "WRAPPERS", "launch_counts", "reset_launch_counts"]

#: kernel name -> the wrapper that launches it and counts its launches
WRAPPERS = {
    "layer_norm": layer_norm,
    "softmax": softmax,
    "flash_attention_fwd": flash_attention_forward,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "flash_attention_bwd_dkv_dbias": flash_attention_bwd_dkv_dbias,
    "flash_decode": paged_flash_decode,
    "trainer_adam": multi_trainer_adam,
    "trainer_sgd_mom": multi_trainer_sgd_mom,
    "fused_bottleneck": fused_bottleneck,
    "sgd_mom_flat": fused_sgd_mom_flat,
    "adam_flat": fused_adam_flat,
    "adamw_flat": fused_adamw_flat,
    "sgd_mom_flat_bf16": fused_sgd_mom_flat_bf16,
    "adam_flat_bf16": fused_adam_flat_bf16,
    "adamw_flat_bf16": fused_adamw_flat_bf16,
    "int8_matmul": int8_matmul,
    "layer_norm_bf16": layer_norm_bf16,
    "softmax_bf16": softmax_bf16,
    "flash_attention_fwd_bf16": flash_attention_fwd_bf16,
    "flash_attention_bwd_dq_bf16": flash_attention_bwd_dq_bf16,
    "flash_attention_bwd_dkv_bf16": flash_attention_bwd_dkv_bf16,
    "flash_attention_bwd_dkv_dbias_bf16": flash_attention_bwd_dkv_dbias_bf16,
    "flash_decode_bf16": paged_flash_decode_bf16,
    "layer_norm_f16": layer_norm_f16,
    "softmax_f16": softmax_f16,
    "flash_attention_fwd_f16": flash_attention_fwd_f16,
    "flash_attention_bwd_dq_f16": flash_attention_bwd_dq_f16,
    "flash_attention_bwd_dkv_f16": flash_attention_bwd_dkv_f16,
    "flash_attention_bwd_dkv_dbias_f16": flash_attention_bwd_dkv_dbias_f16,
    "flash_decode_f16": paged_flash_decode_f16,
    "sgd_mom_flat_f16": fused_sgd_mom_flat_f16,
    "adam_flat_f16": fused_adam_flat_f16,
    "adamw_flat_f16": fused_adamw_flat_f16,
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
