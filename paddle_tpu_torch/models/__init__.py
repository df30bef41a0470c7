"""Models of the port."""

from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel)
from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM, apply_llama_remat

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "GPTConfig", "GPTForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "apply_llama_remat"]
