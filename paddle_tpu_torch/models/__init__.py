"""Models of the port."""

from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel)
from .gpt import GPTConfig, GPTForCausalLM, apply_gpt_tp
from .llama import (LlamaConfig, LlamaForCausalLM, apply_llama_remat,
                    apply_llama_tp)

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "GPTConfig", "GPTForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "apply_gpt_tp", "apply_llama_remat",
           "apply_llama_tp"]
