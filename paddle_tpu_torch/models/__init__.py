"""Models of the port."""

from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel)
from .gpt import GPTConfig, GPTForCausalLM, apply_gpt_tp
from .llama import (LlamaConfig, LlamaForCausalLM, apply_llama_remat,
                    apply_llama_tp)
from .unet import UNet2DModel, UNetConfig, ddpm_loss

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "GPTConfig", "GPTForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "apply_gpt_tp", "apply_llama_remat",
           "apply_llama_tp", "UNet2DModel", "UNetConfig", "ddpm_loss"]
