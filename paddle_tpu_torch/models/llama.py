"""Llama: the counterpart of ``paddle_tpu/models/llama.py`` — the dense
causal ``forward`` (flash attention and fused RoPE kernels) with its loss
(``labels``: the fused linear cross-entropy, llama.py:583-602), the
rectangular ``generate`` with its static-size KV cache (``decode_step``),
and the engine's paged contract (``paged_spec`` / ``paged_prefill`` /
``paged_prefill_ragged`` / ``paged_decode`` / ``paged_verify``,
llama.py:606-701).

Layout follows the JAX package so that its parameters load name for name
(``weights.from_paddle_tpu_state``): Linear weights are ``[in, out]``,
attention tensors ``[B, S, H, D]``, page pools ``[N, page, H_kv, D]`` per
layer. Where JAX threads donated pools and caches through its programs,
the port writes the batch's KV into them IN PLACE before attention reads
them, and returns the same tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..amp import amp_add, amp_cast
from ..device import resolve_device
from ..distributed.fleet.utils.recompute import recompute
from ..inference.engine import PagedGenerationMixin, sample_tokens
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F
from ..ops.kernels.decode_attention import NEG_INF
from ..quantization import page_quant


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
    recompute: bool = False
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


class LlamaAttention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        kv_out = self.num_kv_heads * self.head_dim
        kw = {"device": device, "dtype": dtype}
        self.q_proj = Linear(h, h, bias_attr=False, **kw)
        self.k_proj = Linear(h, kv_out, bias_attr=False, **kw)
        self.v_proj = Linear(h, kv_out, bias_attr=False, **kw)
        self.o_proj = Linear(h, h, bias_attr=False, **kw)

    def _proj(self, hidden):
        b, s = hidden.shape[0], hidden.shape[1]
        q = self.q_proj(hidden).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        return q, k, v

    def _qkv(self, hidden, cos, sin):
        """q, k rotated by the per-token table rows cos/sin ([B, D] or
        [B, Q, D], one RoPE launch), and v."""
        q, k, v = self._proj(hidden)
        q, k = F.fused_rope_qk(q, k, cos, sin)
        return q, k, v

    def forward(self, hidden, rope_cos, rope_sin, attn_mask=None,
                kv_cache=None):
        """Dense causal attention. hidden [B, S, h]; rope_cos/rope_sin
        [S, hd] (the table rows of the S positions); kv_cache (k, v)
        [B, S_past, H_kv, hd] is prepended to this call's K/V, and then the
        return is (out, (k, v)) with the grown cache."""
        b, s = hidden.shape[0], hidden.shape[1]
        q, k, v = self._proj(hidden)
        q, k = F.fused_rope_qk(q, k, rope_cos, rope_sin)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            training=self.training)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return out if kv_cache is None else (out, (k, v))

    def decode_step(self, hidden, rope_cos, rope_sin, cache_k, cache_v, pos):
        """Single-token step over a static-size cache. hidden [B, 1, h];
        rope_cos/rope_sin [1, hd]; cache_k/cache_v [B, L_max, H_kv, hd],
        written at `pos` (a python int) in place. Returns (out, cache_k,
        cache_v)."""
        q, k, v = self._proj(hidden)
        q, k = F.fused_rope_qk(q, k, rope_cos, rope_sin)
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        out = _decode_attention(q, cache_k, cache_v, pos, self.num_heads,
                                self.num_kv_heads)
        return self.o_proj(out.to(hidden.dtype)), cache_k, cache_v

    def paged_decode_step(self, hidden, cos, sin, k_pages, v_pages,
                          block_tables, context_lens, write_pids,
                          write_offs, k_scales=None, v_scales=None):
        """Single-token step over the paged cache. hidden [B, 1, h];
        cos/sin [B, hd]; k_pages/v_pages this layer's pools
        [N, page, H_kv, hd]; write_pids/write_offs [B]: where each slot's
        new KV lands (written before attention reads it).

        k_scales/v_scales ([N] float32, this layer's per-page scale rows)
        select int8 pools: the rows are quantized into them under the
        offset-0 freeze rule (``page_quant.write_rows``, pools and scale
        rows updated in place) and attention reads them through the
        dequant-fused kernel. Without them the pools are float."""
        b = hidden.shape[0]
        q, k, v = self._qkv(hidden, cos, sin)
        page_quant.write_rows(k_pages, k_scales, write_pids, write_offs,
                              k[:, 0])
        page_quant.write_rows(v_pages, v_scales, write_pids, write_offs,
                              v[:, 0])
        out = F.paged_attention(q[:, 0], k_pages, v_pages, block_tables,
                                context_lens, k_scales=k_scales,
                                v_scales=v_scales)
        out = out.reshape(b, 1, self.num_heads * self.head_dim)
        return self.o_proj(out.to(hidden.dtype))

    def paged_ragged_step(self, hidden, cos, sin, k_pages, v_pages,
                          block_tables, context_lens, q_lens, write_pids,
                          write_offs, k_scales=None, v_scales=None):
        """Ragged chunk step (mixed prefill+decode). hidden [C, Q, h]; row
        r's q_lens[r] real tokens sit at the tail of its paged context;
        cos/sin [C, Q, hd]; write_pids/write_offs [C, Q] (padding targets
        the trash page 0); k_scales/v_scales as in paged_decode_step."""
        b, qm = hidden.shape[0], hidden.shape[1]
        q, k, v = self._qkv(hidden, cos, sin)
        page_quant.write_rows(k_pages, k_scales, write_pids, write_offs, k)
        page_quant.write_rows(v_pages, v_scales, write_pids, write_offs, v)
        out = F.ragged_paged_attention(q, k_pages, v_pages, block_tables,
                                       context_lens, q_lens,
                                       k_scales=k_scales, v_scales=v_scales)
        out = out.reshape(b, qm, self.num_heads * self.head_dim)
        return self.o_proj(out.to(hidden.dtype))


def _decode_attention(q, ck, cv, pos, n_heads, n_kv_heads, scale=None):
    """Single-token attention over a static-size cache, in plain PyTorch as
    the JAX package computes it in plain XLA (llama.py:277): one pass over
    the cache, memory-bound. q [B, 1, H, hd]; ck/cv [B, L_max, H_kv, hd];
    keys past `pos` are masked. Returns [B, 1, H * hd] in q's type."""
    b, _, h, hd = q.shape
    rep = h // n_kv_heads
    qg = q.reshape(b, n_kv_heads, rep, hd)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bgrd,blgd->bgrl", qg, ck.to(q.dtype))
    scores = scores.float() * scale
    valid = torch.arange(ck.shape[1], device=q.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrl,blgd->bgrd", probs, cv.to(q.dtype))
    return out.reshape(b, 1, h * hd)


class LlamaMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        kw = {"device": device, "dtype": dtype}
        self.gate_proj = Linear(h, ffn, bias_attr=False, **kw)
        self.up_proj = Linear(h, ffn, bias_attr=False, **kw)
        self.down_proj = Linear(ffn, h, bias_attr=False, **kw)

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
        return amp_add(hidden,
                       self.mlp(self.post_attention_layernorm(hidden)))

    def forward(self, hidden, rope_cos, rope_sin, attn_mask=None,
                kv_cache=None):
        x = self.self_attn(self.input_layernorm(hidden), rope_cos, rope_sin,
                           attn_mask, kv_cache)
        if kv_cache is None:
            return self._mlp_block(amp_add(hidden, x))
        x, new_cache = x
        return self._mlp_block(amp_add(hidden, x)), new_cache

    def decode_step(self, hidden, rope_cos, rope_sin, cache_k, cache_v, pos):
        x, cache_k, cache_v = self.self_attn.decode_step(
            self.input_layernorm(hidden), rope_cos, rope_sin, cache_k,
            cache_v, pos)
        return self._mlp_block(amp_add(hidden, x)), cache_k, cache_v

    def paged_decode_step(self, hidden, *args, **kw):
        x = self.self_attn.paged_decode_step(self.input_layernorm(hidden),
                                             *args, **kw)
        return self._mlp_block(amp_add(hidden, x))

    def paged_ragged_step(self, hidden, *args, **kw):
        x = self.self_attn.paged_ragged_step(self.input_layernorm(hidden),
                                             *args, **kw)
        return self._mlp_block(amp_add(hidden, x))


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

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        """Dense causal forward over input_ids [B, S] at positions
        [position_offset, position_offset + S). Returns the final hidden
        [B, S, h]; with kv_caches (one (k, v) per layer, or None to prime
        an empty cache) it returns (hidden, the grown caches)."""
        s = input_ids.shape[1]
        if position_offset + s > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence positions [{position_offset}, {position_offset + s}"
                f") exceed max_position_embeddings="
                f"{self.config.max_position_embeddings}")
        hidden = self.embed_tokens(input_ids)
        cos = self.rope_cos[position_offset:position_offset + s]
        sin = self.rope_sin[position_offset:position_offset + s]
        if kv_caches is None:
            for layer in self.layers:
                hidden = layer(hidden, cos, sin, attn_mask)
            return self.norm(hidden)
        cfg = self.config
        empty = hidden.new_zeros((hidden.shape[0], 0, cfg.num_key_value_heads,
                                  cfg.hidden_size // cfg.num_attention_heads))
        new_caches = []
        for layer, cache in zip(self.layers, kv_caches):
            hidden, cache = layer(hidden, cos, sin, attn_mask,
                                  (empty, empty) if cache is None else cache)
            new_caches.append(cache)
        return self.norm(hidden), new_caches

    def decode_step(self, token, caches, pos):
        """token [B, 1] int; caches: one (k, v) [B, L_max, H_kv, hd] per
        layer, written at position `pos` in place. Returns (hidden
        [B, 1, h], caches)."""
        hidden = self.embed_tokens(token)
        cos = self.rope_cos[pos:pos + 1]
        sin = self.rope_sin[pos:pos + 1]
        new_caches = []
        for layer, (ck, cv) in zip(self.layers, caches):
            hidden, ck, cv = layer.decode_step(hidden, cos, sin, ck, cv, pos)
            new_caches.append((ck, cv))
        return self.norm(hidden), new_caches

    def paged_decode_step(self, tokens, positions, k_pages, v_pages,
                          block_tables, context_lens, write_pids, write_offs,
                          k_scales=None, v_scales=None):
        """tokens/positions [B] int64 (each slot's incoming token and its
        position); k_pages/v_pages per-layer pool lists; k_scales/v_scales
        per-layer scale rows of int8 pools (None: float pools). Returns the
        final hidden [B, 1, h]."""
        hidden = self.embed_tokens(tokens[:, None])
        cos = self.rope_cos[positions]
        sin = self.rope_sin[positions]
        n = len(self.layers)
        for layer, kp, vp, ks, vs in zip(self.layers, k_pages, v_pages,
                                         k_scales or [None] * n,
                                         v_scales or [None] * n):
            hidden = layer.paged_decode_step(
                hidden, cos, sin, kp, vp, block_tables, context_lens,
                write_pids, write_offs, k_scales=ks, v_scales=vs)
        return self.norm(hidden)

    def paged_ragged_step(self, ids, q_lens, start_pos, k_pages, v_pages,
                          block_tables, write_pids, write_offs,
                          k_scales=None, v_scales=None):
        """ids [C, Q] int64 right-padded token windows at the tail of each
        row's context; start_pos [C] int32 position of each row's first
        token; q_lens [C] int32; k_scales/v_scales as in
        paged_decode_step. Returns the final hidden [C, Q, h]."""
        hidden = self.embed_tokens(ids)
        qm = ids.shape[1]
        positions = start_pos.long()[:, None] + \
            torch.arange(qm, device=ids.device)[None, :]
        # clamp padding columns (real positions never exceed max_len)
        positions = positions.clamp_max(self.rope_cos.shape[0] - 1)
        cos = self.rope_cos[positions]
        sin = self.rope_sin[positions]
        context_lens = (start_pos + q_lens).to(torch.int32)
        n = len(self.layers)
        for layer, kp, vp, ks, vs in zip(self.layers, k_pages, v_pages,
                                         k_scales or [None] * n,
                                         v_scales or [None] * n):
            hidden = layer.paged_ragged_step(
                hidden, cos, sin, kp, vp, block_tables, context_lens,
                q_lens, write_pids, write_offs, k_scales=ks, v_scales=vs)
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
            config.hidden_size, config.vocab_size, bias_attr=False,
            device=device, dtype=dtype)
        self.eval()

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.llama.embed_tokens.weight.dtype

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits [B, S, V] of the dense causal forward over input_ids
        [B, S]; with labels [B, S] the mean cross-entropy (a 0-dim tensor
        in the model's type) through the fused linear cross-entropy, which
        never holds the [B * S, V] logits (the JAX model's route under its
        default FLAGS_fused_lm_head_ce). Labels are NOT shifted: position i
        is scored against labels[i]; labels below 0 are ignored."""
        hidden = self.llama(input_ids, attn_mask)
        if labels is None:
            return self._head(hidden)
        w = (self.llama.embed_tokens.weight if self.lm_head is None
             else self.lm_head.weight)
        return F.fused_linear_cross_entropy(
            hidden, w, labels, transpose_weight=self.lm_head is None)

    def paged_spec(self):
        cfg = self.config
        return {"n_layers": cfg.num_hidden_layers,
                "n_kv_heads": cfg.num_key_value_heads,
                "head_dim": cfg.hidden_size // cfg.num_attention_heads,
                "max_len": cfg.max_position_embeddings}

    def paged_prefill(self, ids, lengths):
        """Engine dense prefill: ids [C, S_pad] right-padded prompts,
        lengths [C]. Runs the dense causal forward (padding past a row's
        length cannot leak backward under the causal mask) and returns
        (each row's last-real-token logits [C, V], ks, vs
        [L, C, S_pad, H_kv, hd])."""
        hidden, kv = self.llama(ids, kv_caches=[None] * len(self.llama.layers))
        rows = torch.arange(ids.shape[0], device=ids.device)
        h_last = hidden[rows, lengths.long() - 1][:, None]
        ks = torch.stack([k for k, _ in kv])
        vs = torch.stack([v for _, v in kv])
        return self._head(h_last)[:, 0], ks, vs

    def paged_decode(self, tokens, positions, k_pages, v_pages,
                     block_tables, context_lens, write_pids, write_offs,
                     k_scales=None, v_scales=None):
        """Engine decode step -> (logits [B, V], k_pages, v_pages[,
        k_scales, v_scales]); the pools (and, for int8 pools, the per-layer
        scale rows) are updated in place and returned as given."""
        hidden = self.llama.paged_decode_step(
            tokens, positions, k_pages, v_pages, block_tables, context_lens,
            write_pids, write_offs, k_scales=k_scales, v_scales=v_scales)
        out = (self._head(hidden)[:, 0], k_pages, v_pages)
        return out if k_scales is None else out + (k_scales, v_scales)

    def paged_prefill_ragged(self, ids, q_lens, start_pos, k_pages, v_pages,
                             block_tables, write_pids, write_offs,
                             k_scales=None, v_scales=None):
        """Engine ragged step (chunked/suffix prefill + mixed decode in one
        launch per layer) -> (each row's last-real-token logits [C, V],
        k_pages, v_pages[, k_scales, v_scales])."""
        hidden = self.llama.paged_ragged_step(
            ids, q_lens, start_pos, k_pages, v_pages, block_tables,
            write_pids, write_offs, k_scales=k_scales, v_scales=v_scales)
        c = ids.shape[0]
        rows = torch.arange(c, device=ids.device)
        h_last = hidden[rows, q_lens.long() - 1][:, None]
        out = (self._head(h_last)[:, 0], k_pages, v_pages)
        return out if k_scales is None else out + (k_scales, v_scales)

    def paged_verify(self, ids, q_lens, start_pos, k_pages, v_pages,
                     block_tables, write_pids, write_offs, k_scales=None,
                     v_scales=None):
        """Speculative-decode verify: the ragged step of
        ``paged_prefill_ragged`` (each row a window of 1 + drafts tokens at
        the tail of its paged context), with the head at EVERY position,
        so that the engine can accept the longest draft prefix the greedy
        argmax confirms -> (logits [C, Q, V], k_pages, v_pages[, k_scales,
        v_scales]). Positions at or past a row's q_len are padding."""
        hidden = self.llama.paged_ragged_step(
            ids, q_lens, start_pos, k_pages, v_pages, block_tables,
            write_pids, write_offs, k_scales=k_scales, v_scales=v_scales)
        out = (self._head(hidden), k_pages, v_pages)
        return out if k_scales is None else out + (k_scales, v_scales)

    def _head(self, hidden):
        if self.lm_head is None:
            hidden, w = amp_cast("matmul", hidden,
                                 self.llama.embed_tokens.weight)
            return torch.matmul(hidden, w.t())
        return self.lm_head(hidden)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 use_cache=True, seed=None, engine=False):
        """Greedy (temperature 0) or sampled decoding of a rectangular batch
        input_ids [B, S] (tensor or array). Returns [B, S + max_new_tokens]
        on the model's device, in input_ids' integer type.

        use_cache=True: one dense prefill through ``forward`` with KV
        caches, copied into static-size [B, S + max_new_tokens, H_kv, hd]
        buffers, then a loop of ``decode_step``. use_cache=False recomputes
        the whole sequence for every token (the parity path). engine=True
        goes through the paged GenerationEngine instead (the serving path).
        Sampling draws from a torch.Generator seeded with `seed` (or
        randomly): greedy tokens match the JAX package's, sampled ones do
        not (its random keys differ)."""
        self.eval()
        ids = torch.as_tensor(input_ids, device=self.device)
        if ids.dim() == 1:
            ids = ids[None]
        if max_new_tokens <= 0:
            return ids
        if engine:
            out = self.get_engine().generate(ids, max_new_tokens, temperature,
                                             seed=seed)
            return torch.as_tensor(out, device=self.device).to(ids.dtype)
        gen = torch.Generator(device=self.device)
        if seed is None:
            gen.seed()
        else:
            gen.manual_seed(int(seed))
        toks = ids.long()
        b, s = toks.shape
        temps = None if temperature == 0.0 else torch.full(
            (b,), float(temperature), device=self.device)

        def pick(hidden):          # next token from the last position
            return sample_tokens(self._head(hidden[:, -1:])[:, 0], temps,
                                 gen)

        if not use_cache:
            for _ in range(max_new_tokens):
                toks = torch.cat([toks, pick(self.llama(toks))[:, None]],
                                 dim=1)
            return toks.to(ids.dtype)

        total = s + max_new_tokens
        if total > self.config.max_position_embeddings:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_position_embeddings="
                f"{self.config.max_position_embeddings}")
        hidden, kv = self.llama(toks,
                                kv_caches=[None] * len(self.llama.layers))
        caches = []
        for k, v in kv:            # static-size buffers for the decode loop
            ck = k.new_zeros((b, total) + tuple(k.shape[2:]))
            cv = v.new_zeros((b, total) + tuple(v.shape[2:]))
            ck[:, :s] = k
            cv[:, :s] = v
            caches.append((ck, cv))
        out = [pick(hidden)]
        for pos in range(s, total - 1):
            hidden, caches = self.llama.decode_step(out[-1][:, None], caches,
                                                    pos)
            out.append(pick(hidden))
        return torch.cat([toks, torch.stack(out, dim=1)], dim=1).to(ids.dtype)


def apply_llama_remat(model):
    """Recompute each decoder layer's activations in the backward
    (``apply_llama_remat``, ``paddle_tpu/models/llama.py:880``): every
    layer's ``forward`` is wrapped so that a training forward (grad mode,
    no ``kv_cache``) goes through ``distributed.fleet.utils.recompute``,
    which replays the layer's dropout draws; calls with a ``kv_cache`` and
    the paged steps are left alone. ``LlamaConfig.recompute`` changes
    nothing by itself, as in the JAX package. Returns the model."""
    for layer in model.llama.layers:
        def make(fn):
            def wrapped(hidden, cos, sin, attn_mask=None, kv_cache=None):
                if kv_cache is not None:
                    return fn(hidden, cos, sin, attn_mask, kv_cache)
                return recompute(fn, hidden, cos, sin, attn_mask)
            return wrapped
        layer.forward = make(layer.forward)
    return model
