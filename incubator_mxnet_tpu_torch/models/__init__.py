"""Models of the PyTorch port."""

from .bert import BERTModel, bert_base, bert_large, params_from_jax
from .gpt import GPTDecoder, gpt_config, gpt_forward_paged, gpt_logits

__all__ = ["BERTModel", "bert_base", "bert_large", "params_from_jax",
           "GPTDecoder", "gpt_config", "gpt_forward_paged", "gpt_logits"]
