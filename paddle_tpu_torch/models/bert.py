"""BERT: the counterpart of ``paddle_tpu/models/bert.py`` (BASELINE config
2 is ``BertConfig.bert_base()``) — ``BertEmbeddings``, ``BertModel`` (the
encoder is ``nn.TransformerEncoder``, so attention without a mask in eval
is the flash kernel, non-causal), ``BertForMaskedLM`` (tied head, loss
with ``ignore_index=-100``) and ``BertForSequenceClassification``. Forward
and loss only.

An ``attention_mask`` [B, S] of 1 (attend) and 0 (padding) becomes the
additive mask (1 - m) * -1e4 of shape [B, 1, 1, S] (bert.py:80-84), which
routes attention to the dense plain path, as in JAX. Parameter names are
the JAX model's, so ``weights.from_paddle_tpu_state`` loads them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..amp import amp_add, amp_cast
from ..device import resolve_device
from ..nn import (GELU, Dropout, Embedding, LayerNorm, Linear, Sequential,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn import functional as F


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    @staticmethod
    def bert_base():
        return BertConfig()

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, ffn=128, seq=64):
        return BertConfig(vocab_size=vocab, hidden_size=hidden,
                          num_hidden_layers=layers, num_attention_heads=heads,
                          intermediate_size=ffn,
                          max_position_embeddings=seq)


class BertEmbeddings(nn.Module):
    """Word + position (+ token type) embeddings, LayerNorm, dropout."""

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        emb = amp_add(self.word_embeddings(input_ids),
                      self.position_embeddings(pos))
        if token_type_ids is not None:
            emb = amp_add(emb, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Module):
    """Embeddings, the post-LN encoder stack (GELU, exact) and the tanh
    pooler over the first token. Returns (sequence [B, S, h], pooled
    [B, h]). ``device=None`` means the CUDA card; ``dtype=None`` the
    default float type."""

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation="gelu",
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(enc_layer,
                                          config.num_hidden_layers)
        self.pooler = Linear(config.hidden_size, config.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        am = None
        if attention_mask is not None:
            am = (1.0 - attention_mask.float()) * -1e4
            am = am.reshape(am.shape[0], 1, 1, am.shape[1])
        seq = self.encoder(x, am)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForMaskedLM(nn.Module):
    """BertModel, a transform (Linear, GELU, LayerNorm) and the head tied
    to the word embeddings: logits [B, S, V], or with labels the mean
    cross-entropy over the labels that are not -100."""

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.config = config
        self.bert = BertModel(config, **kw)
        self.transform = Sequential(
            Linear(config.hidden_size, config.hidden_size, **kw), GELU(),
            LayerNorm(config.hidden_size, config.layer_norm_eps, **kw))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        hidden = self.transform(seq)
        hidden, w = amp_cast("matmul", hidden,
                             self.bert.embeddings.word_embeddings.weight)
        logits = torch.matmul(hidden, w.t())
        if labels is not None:
            return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                   labels.reshape(-1), ignore_index=-100)
        return logits


class BertForSequenceClassification(nn.Module):
    """BertModel's pooled output through dropout and a classifier: logits
    [B, num_classes], or with labels [B] the mean cross-entropy."""

    def __init__(self, config, num_classes=2, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.bert = BertModel(config, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits
