"""Llama for paged serving: the counterpart of
``paddle_tpu/models/llama.py`` restricted to the engine's ragged and
decode contract (``paged_spec`` / ``paged_prefill_ragged`` /
``paged_decode``, llama.py:606-678).

Layout follows the JAX package so that its parameters load name for name
(``weights.from_paddle_tpu_state``): Linear weights are ``[in, out]``,
attention tensors ``[B, S, H, D]``, page pools ``[N, page, H_kv, D]`` per
layer. Where JAX threads donated pools through its programs, the port
writes the batch's KV into the pools IN PLACE (``index_put_``) before
attention reads them, and returns the same pool lists.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..inference.engine import PagedGenerationMixin
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128,
             seq=64):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=ffn, num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           max_position_embeddings=seq)


def _rope_tables(head_dim, max_len, theta):
    """float32 cos/sin tables [max_len, head_dim], computed in float64 by
    numpy exactly as the JAX package does, then cast."""
    pos = np.arange(max_len)[:, None]
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    ang = pos * inv
    cos = np.concatenate([np.cos(ang), np.cos(ang)], -1)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], -1)
    return (torch.from_numpy(cos.astype(np.float32)),
            torch.from_numpy(sin.astype(np.float32)))


def _rope_rows(x, cos, sin):
    """Rotate-half RoPE with per-token positions: x [B, Q, H, D]; cos/sin
    [B, D] (Q = 1 decode) or [B, Q, D] (ragged chunk), the table rows at
    each token's own position."""
    if cos.dim() == 3:
        cos = cos[:, :, None, :].to(x.dtype)
        sin = sin[:, :, None, :].to(x.dtype)
    else:
        cos = cos[:, None, None, :].to(x.dtype)
        sin = sin[:, None, None, :].to(x.dtype)
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


class LlamaAttention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        kv_out = self.num_kv_heads * self.head_dim
        kw = {"device": device, "dtype": dtype}
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, kv_out, **kw)
        self.v_proj = Linear(h, kv_out, **kw)
        self.o_proj = Linear(h, h, **kw)

    def _qkv(self, hidden, cos, sin):
        b, s = hidden.shape[0], hidden.shape[1]
        q = self.q_proj(hidden).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        return _rope_rows(q, cos, sin), _rope_rows(k, cos, sin), v

    def paged_decode_step(self, hidden, cos, sin, k_pages, v_pages,
                          block_tables, context_lens, write_pids,
                          write_offs):
        """Single-token step over the paged cache. hidden [B, 1, h];
        cos/sin [B, hd]; k_pages/v_pages this layer's pools
        [N, page, H_kv, hd]; write_pids/write_offs [B]: where each slot's
        new KV lands (written before attention reads it)."""
        b = hidden.shape[0]
        q, k, v = self._qkv(hidden, cos, sin)
        k_pages.index_put_((write_pids, write_offs), k[:, 0].to(k_pages.dtype))
        v_pages.index_put_((write_pids, write_offs), v[:, 0].to(v_pages.dtype))
        out = F.paged_attention(q[:, 0], k_pages, v_pages, block_tables,
                                context_lens)
        out = out.reshape(b, 1, self.num_heads * self.head_dim)
        return self.o_proj(out.to(hidden.dtype))

    def paged_ragged_step(self, hidden, cos, sin, k_pages, v_pages,
                          block_tables, context_lens, q_lens, write_pids,
                          write_offs):
        """Ragged chunk step (mixed prefill+decode). hidden [C, Q, h]; row
        r's q_lens[r] real tokens sit at the tail of its paged context;
        cos/sin [C, Q, hd]; write_pids/write_offs [C, Q] (padding targets
        the trash page 0)."""
        b, qm = hidden.shape[0], hidden.shape[1]
        q, k, v = self._qkv(hidden, cos, sin)
        k_pages.index_put_((write_pids, write_offs), k.to(k_pages.dtype))
        v_pages.index_put_((write_pids, write_offs), v.to(v_pages.dtype))
        out = F.ragged_paged_attention(q, k_pages, v_pages, block_tables,
                                       context_lens, q_lens)
        out = out.reshape(b, qm, self.num_heads * self.head_dim)
        return self.o_proj(out.to(hidden.dtype))


class LlamaMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        kw = {"device": device, "dtype": dtype}
        self.gate_proj = Linear(h, ffn, **kw)
        self.up_proj = Linear(h, ffn, **kw)
        self.down_proj = Linear(ffn, h, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attn = LlamaAttention(config, **kw)
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)

    def _mlp_block(self, hidden):
        return hidden + self.mlp(self.post_attention_layernorm(hidden))

    def paged_decode_step(self, hidden, *args):
        x = self.self_attn.paged_decode_step(self.input_layernorm(hidden),
                                             *args)
        return self._mlp_block(hidden + x)

    def paged_ragged_step(self, hidden, *args):
        x = self.self_attn.paged_ragged_step(self.input_layernorm(hidden),
                                             *args)
        return self._mlp_block(hidden + x)


class LlamaModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_tables(config.hidden_size //
                                config.num_attention_heads,
                                config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("rope_cos", cos.to(device), persistent=False)
        self.register_buffer("rope_sin", sin.to(device), persistent=False)

    def paged_decode_step(self, tokens, positions, k_pages, v_pages,
                          block_tables, context_lens, write_pids, write_offs):
        """tokens/positions [B] int64 (each slot's incoming token and its
        position); k_pages/v_pages per-layer pool lists. Returns the final
        hidden [B, 1, h]."""
        hidden = self.embed_tokens(tokens[:, None])
        cos = self.rope_cos[positions]
        sin = self.rope_sin[positions]
        for layer, kp, vp in zip(self.layers, k_pages, v_pages):
            hidden = layer.paged_decode_step(
                hidden, cos, sin, kp, vp, block_tables, context_lens,
                write_pids, write_offs)
        return self.norm(hidden)

    def paged_ragged_step(self, ids, q_lens, start_pos, k_pages, v_pages,
                          block_tables, write_pids, write_offs):
        """ids [C, Q] int64 right-padded token windows at the tail of each
        row's context; start_pos [C] int32 position of each row's first
        token; q_lens [C] int32. Returns the final hidden [C, Q, h]."""
        hidden = self.embed_tokens(ids)
        qm = ids.shape[1]
        positions = start_pos.long()[:, None] + \
            torch.arange(qm, device=ids.device)[None, :]
        # clamp padding columns (real positions never exceed max_len)
        positions = positions.clamp_max(self.rope_cos.shape[0] - 1)
        cos = self.rope_cos[positions]
        sin = self.rope_sin[positions]
        context_lens = (start_pos + q_lens).to(torch.int32)
        for layer, kp, vp in zip(self.layers, k_pages, v_pages):
            hidden = layer.paged_ragged_step(
                hidden, cos, sin, kp, vp, block_tables, context_lens,
                q_lens, write_pids, write_offs)
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module, PagedGenerationMixin):
    """Llama with the paged serving contract. ``device=None`` means the
    CUDA card (raises without one); pass ``device="cpu"`` for the plain
    PyTorch path. ``dtype=None`` takes ``config.dtype``."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        dtype = getattr(torch, config.dtype) if dtype is None else dtype
        self.llama = LlamaModel(config, device=device, dtype=dtype)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, device=device,
            dtype=dtype)
        self.eval()

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.llama.embed_tokens.weight.dtype

    def paged_spec(self):
        cfg = self.config
        return {"n_layers": cfg.num_hidden_layers,
                "n_kv_heads": cfg.num_key_value_heads,
                "head_dim": cfg.hidden_size // cfg.num_attention_heads,
                "max_len": cfg.max_position_embeddings}

    def paged_decode(self, tokens, positions, k_pages, v_pages,
                     block_tables, context_lens, write_pids, write_offs):
        """Engine decode step -> (logits [B, V], k_pages, v_pages); the
        pools are updated in place and returned as given."""
        hidden = self.llama.paged_decode_step(
            tokens, positions, k_pages, v_pages, block_tables, context_lens,
            write_pids, write_offs)
        return self._head(hidden)[:, 0], k_pages, v_pages

    def paged_prefill_ragged(self, ids, q_lens, start_pos, k_pages, v_pages,
                             block_tables, write_pids, write_offs):
        """Engine ragged step (chunked/suffix prefill + mixed decode in one
        launch per layer) -> (each row's last-real-token logits [C, V],
        k_pages, v_pages)."""
        hidden = self.llama.paged_ragged_step(
            ids, q_lens, start_pos, k_pages, v_pages, block_tables,
            write_pids, write_offs)
        c = ids.shape[0]
        rows = torch.arange(c, device=ids.device)
        h_last = hidden[rows, q_lens.long() - 1][:, None]
        return self._head(h_last)[:, 0], k_pages, v_pages

    def _head(self, hidden):
        if self.lm_head is None:
            return torch.matmul(hidden, self.llama.embed_tokens.weight.t())
        return self.lm_head(hidden)
