"""Models of the PyTorch port."""

from .bert import (BERTForPretrain, BERTModel, bert_base, bert_large,
                   params_from_jax, pretrain_params_from_jax)
from .gpt import GPTDecoder, gpt_config, gpt_forward_paged, gpt_logits
from .lstm_lm import RNNModel, lstm_lm_ptb

__all__ = ["BERTModel", "BERTForPretrain", "bert_base", "bert_large",
           "params_from_jax", "pretrain_params_from_jax", "GPTDecoder",
           "gpt_config", "gpt_forward_paged", "gpt_logits", "RNNModel",
           "lstm_lm_ptb"]
