"""GPT: the counterpart of ``paddle_tpu/models/gpt.py`` (GPT-2/3 style:
learned positions, pre-LN blocks, GELU MLP, tied head; BASELINE config 3
is ``GPTConfig.gpt3_1p3b()``) — the dense causal ``forward`` (the flash
kernel) with its loss, and the engine's paged contract (``paged_spec``
:363, ``paged_prefill`` :370, ``paged_decode`` :381,
``paged_prefill_ragged`` :397, ``paged_verify`` :422), float and int8
pages. ``generate`` goes through the engine (:451), and
``PagedGenerationMixin`` gives ``generate_batch`` and ``stream_generate``.

Parameter names and layouts are the JAX model's (``gpt.h.0.attn.qkv_proj
.weight`` ``[h, 3h]``, ``gpt.h.0.mlp.2.weight``, ...), so
``weights.from_paddle_tpu_state`` loads them name for name. GPT is
multi-head (as many KV heads as query heads). As in the port's Llama, the
paged steps write the batch's KV into the pools IN PLACE before attention
reads them. Not ported: ``paged_decode_dense`` (the JAX engine's off-TPU
decode, which the port's engine never calls) and ``apply_gpt_tp`` (tensor
parallelism).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..amp import amp_add, amp_cast
from ..device import resolve_device
from ..inference.engine import PagedGenerationMixin
from ..nn import GELU, Dropout, Embedding, LayerList, LayerNorm, Linear
from ..nn import Sequential
from ..nn import functional as F
from ..quantization import page_quant


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    layer_norm_epsilon: float = 1e-5
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    dtype: str = "float32"

    @staticmethod
    def gpt3_1p3b():
        return GPTConfig(hidden_size=2048, num_hidden_layers=24,
                         num_attention_heads=16, intermediate_size=8192)

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, ffn=128, seq=64):
        return GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         intermediate_size=ffn, max_position_embeddings=seq)


class GPTAttention(nn.Module):
    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        kw = {"device": device, "dtype": dtype}
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout = config.attention_dropout

    def _qkv(self, x):
        """q, k, v [B, S, H, hd] from the packed projection, each made
        contiguous (the kernels index packed strides)."""
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        return tuple(qkv[:, :, i].contiguous() for i in range(3))

    def _out(self, out, x):
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.num_heads *
                                         self.head_dim).to(x.dtype))

    def forward(self, x, return_kv=False):
        """Dense causal attention; with return_kv also this layer's (k, v)
        [B, S, H, hd]."""
        q, k, v = self._qkv(x)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training)
        out = self._out(out, x)
        return (out, (k, v)) if return_kv else out

    def paged_decode_step(self, x, k_pages, v_pages, block_tables,
                          context_lens, write_pids, write_offs,
                          k_scales=None, v_scales=None):
        """Single-token step over the paged cache. x [B, 1, h]; this
        layer's pools [N, page, H, hd]; write_pids/write_offs [B]: where
        each slot's new KV lands (written before attention reads it).
        k_scales/v_scales ([N] float32) select int8 pools (quantized
        through ``page_quant.write_rows``, updated in place)."""
        q, k, v = self._qkv(x)
        page_quant.write_rows(k_pages, k_scales, write_pids, write_offs,
                              k[:, 0])
        page_quant.write_rows(v_pages, v_scales, write_pids, write_offs,
                              v[:, 0])
        out = F.paged_attention(q[:, 0], k_pages, v_pages, block_tables,
                                context_lens, k_scales=k_scales,
                                v_scales=v_scales)
        return self._out(out[:, None], x)

    def paged_ragged_step(self, x, k_pages, v_pages, block_tables,
                          context_lens, q_lens, write_pids, write_offs,
                          k_scales=None, v_scales=None):
        """Ragged chunk step (mixed prefill+decode). x [C, Q, h]; row r's
        q_lens[r] real tokens sit at the tail of its paged context;
        write_pids/write_offs [C, Q] (padding targets the trash page 0)."""
        q, k, v = self._qkv(x)
        page_quant.write_rows(k_pages, k_scales, write_pids, write_offs, k)
        page_quant.write_rows(v_pages, v_scales, write_pids, write_offs, v)
        out = F.ragged_paged_attention(q, k_pages, v_pages, block_tables,
                                       context_lens, q_lens,
                                       k_scales=k_scales, v_scales=v_scales)
        return self._out(out, x)


class GPTBlock(nn.Module):
    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        kw = {"device": device, "dtype": dtype}
        self.ln_1 = LayerNorm(h, config.layer_norm_epsilon, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(h, config.layer_norm_epsilon, **kw)
        self.mlp = Sequential(
            Linear(h, config.intermediate_size, **kw), GELU(),
            Linear(config.intermediate_size, h, **kw))
        self.drop = Dropout(config.hidden_dropout)

    def forward(self, x, return_kv=False):
        a = self.attn(self.ln_1(x), return_kv=return_kv)
        if return_kv:
            a, kv = a
        x = amp_add(x, self.drop(a))
        x = amp_add(x, self.drop(self.mlp(self.ln_2(x))))
        return (x, kv) if return_kv else x

    def _paged(self, step, x, *args, **kw):
        x = amp_add(x, step(self.ln_1(x), *args, **kw))
        return amp_add(x, self.mlp(self.ln_2(x)))

    def paged_decode_step(self, x, *args, **kw):
        return self._paged(self.attn.paged_decode_step, x, *args, **kw)

    def paged_ragged_step(self, x, *args, **kw):
        return self._paged(self.attn.paged_ragged_step, x, *args, **kw)


class GPTModel(nn.Module):
    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.h = LayerList([GPTBlock(config, **kw)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              **kw)

    def forward(self, input_ids, return_kv=False):
        """Final hidden [B, S, h] of the dense causal forward over
        input_ids [B, S] at positions [0, S); with return_kv also each
        layer's (k, v)."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None]
        x = amp_add(self.wte(input_ids), self.wpe(pos))
        kvs = []
        for block in self.h:
            x = block(x, return_kv=return_kv)
            if return_kv:
                x, kv = x
                kvs.append(kv)
        x = self.ln_f(x)
        return (x, kvs) if return_kv else x

    def _layers(self, step, x, k_pages, v_pages, k_scales, v_scales, *args):
        n = len(self.h)
        for block, kp, vp, ks, vs in zip(self.h, k_pages, v_pages,
                                         k_scales or [None] * n,
                                         v_scales or [None] * n):
            x = getattr(block, step)(x, kp, vp, *args, k_scales=ks,
                                     v_scales=vs)
        return self.ln_f(x)

    def paged_decode_step(self, tokens, positions, k_pages, v_pages,
                          block_tables, context_lens, write_pids,
                          write_offs, k_scales=None, v_scales=None):
        """tokens/positions [B] int64 (each slot's token and its own
        position, looked up in wpe unclamped); per-layer pool lists (and
        scale rows of int8 pools). Returns the final hidden [B, 1, h]."""
        x = amp_add(self.wte(tokens[:, None]), self.wpe(positions[:, None]))
        return self._layers("paged_decode_step", x, k_pages, v_pages,
                            k_scales, v_scales, block_tables, context_lens,
                            write_pids, write_offs)

    def paged_ragged_step(self, ids, q_lens, start_pos, k_pages, v_pages,
                          block_tables, write_pids, write_offs,
                          k_scales=None, v_scales=None):
        """ids [C, Q] right-padded token windows at the tail of each row's
        context; start_pos [C] the position of each row's first token
        (positions of padding columns clamp to the table's last row, as in
        JAX). Returns the final hidden [C, Q, h]."""
        qm = ids.shape[1]
        positions = start_pos.long()[:, None] + \
            torch.arange(qm, device=ids.device)[None, :]
        positions = positions.clamp_max(
            self.config.max_position_embeddings - 1)
        x = amp_add(self.wte(ids), self.wpe(positions))
        context_lens = (start_pos + q_lens).to(torch.int32)
        return self._layers("paged_ragged_step", x, k_pages, v_pages,
                            k_scales, v_scales, block_tables, context_lens,
                            q_lens, write_pids, write_offs)


class GPTForCausalLM(nn.Module, PagedGenerationMixin):
    """GPT with the tied head and the paged serving contract.
    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain PyTorch path. ``dtype=None`` takes
    ``config.dtype``."""

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        dtype = getattr(torch, config.dtype) if dtype is None else dtype
        self.gpt = GPTModel(config, device=device, dtype=dtype)
        self.eval()

    @property
    def device(self):
        return self.gpt.wte.weight.device

    @property
    def dtype(self):
        return self.gpt.wte.weight.dtype

    def _head(self, hidden):
        hidden, w = amp_cast("matmul", hidden, self.gpt.wte.weight)
        return torch.matmul(hidden, w.t())

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V] (the head tied to wte); with labels [B, S] the
        mean cross-entropy over labels not -100, unshifted (position i
        against labels[i]), on the materialized logits as in JAX."""
        logits = self._head(self.gpt(input_ids))
        if labels is not None:
            return F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size),
                labels.reshape(-1))
        return logits

    def paged_spec(self):
        cfg = self.config
        return {"n_layers": cfg.num_hidden_layers,
                "n_kv_heads": cfg.num_attention_heads,    # MHA: kv == q
                "head_dim": cfg.hidden_size // cfg.num_attention_heads,
                "max_len": cfg.max_position_embeddings}

    def paged_prefill(self, ids, lengths):
        """Engine dense prefill: ids [C, S_pad] right-padded prompts,
        lengths [C] -> (each row's last-real-token logits [C, V], ks, vs
        [L, C, S_pad, H, hd])."""
        hidden, kv = self.gpt(ids, return_kv=True)
        rows = torch.arange(ids.shape[0], device=ids.device)
        h_last = hidden[rows, lengths.long() - 1][:, None]
        ks = torch.stack([k for k, _ in kv])
        vs = torch.stack([v for _, v in kv])
        return self._head(h_last)[:, 0], ks, vs

    def paged_decode(self, tokens, positions, k_pages, v_pages,
                     block_tables, context_lens, write_pids, write_offs,
                     k_scales=None, v_scales=None):
        """Engine decode step -> (logits [B, V], k_pages, v_pages[,
        k_scales, v_scales]), pools updated in place."""
        hidden = self.gpt.paged_decode_step(
            tokens, positions, k_pages, v_pages, block_tables, context_lens,
            write_pids, write_offs, k_scales=k_scales, v_scales=v_scales)
        out = (self._head(hidden)[:, 0], k_pages, v_pages)
        return out if k_scales is None else out + (k_scales, v_scales)

    def paged_prefill_ragged(self, ids, q_lens, start_pos, k_pages, v_pages,
                             block_tables, write_pids, write_offs,
                             k_scales=None, v_scales=None):
        """Engine ragged step -> (each row's last-real-token logits
        [C, V], k_pages, v_pages[, k_scales, v_scales])."""
        hidden = self.gpt.paged_ragged_step(
            ids, q_lens, start_pos, k_pages, v_pages, block_tables,
            write_pids, write_offs, k_scales=k_scales, v_scales=v_scales)
        rows = torch.arange(ids.shape[0], device=ids.device)
        h_last = hidden[rows, q_lens.long() - 1][:, None]
        out = (self._head(h_last)[:, 0], k_pages, v_pages)
        return out if k_scales is None else out + (k_scales, v_scales)

    def paged_verify(self, ids, q_lens, start_pos, k_pages, v_pages,
                     block_tables, write_pids, write_offs, k_scales=None,
                     v_scales=None):
        """Speculative-decode verify: the ragged step with the head at
        EVERY position -> (logits [C, Q, V], k_pages, v_pages[, k_scales,
        v_scales])."""
        hidden = self.gpt.paged_ragged_step(
            ids, q_lens, start_pos, k_pages, v_pages, block_tables,
            write_pids, write_offs, k_scales=k_scales, v_scales=v_scales)
        out = (self._head(hidden), k_pages, v_pages)
        return out if k_scales is None else out + (k_scales, v_scales)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 seed=None, eos_token_id=None):
        """Greedy or sampled decoding of a rectangular batch input_ids
        [B, S] through the paged engine (the JAX GPT's only generate path).
        Returns [B, S + max_new_tokens] on the model's device in
        input_ids' integer type; rows that stop at eos_token_id are padded
        with it."""
        self.eval()
        ids = torch.as_tensor(input_ids, device=self.device)
        if ids.dim() == 1:
            ids = ids[None]
        if max_new_tokens <= 0:
            return ids
        out = self.get_engine().generate(ids, max_new_tokens, temperature,
                                         seed=seed,
                                         eos_token_id=eos_token_id)
        return torch.as_tensor(out, device=self.device).to(ids.dtype)
