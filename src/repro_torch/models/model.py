"""Decoder LM: the reference's composition for all ten architectures, as
`nn.Module`s.

Port of `repro/models/model.py`.  The reference stores its layers stacked
by period position (`params["blocks"][p]`, a leading (n_repeat,) axis) so
that `lax.scan` runs them; here `DecoderLM.layers` is an `nn.ModuleList`
in layer order (layer i = repeat i // period, position i % period), run
by a Python loop.  `convert.model_from_numpy` loads the reference's
`init_params` tree into it.

A layer's core is the kind at its period position (`cfg.pattern`):
attention, Mamba, mLSTM or sLSTM.  Its MLP is an MoE block where
`cfg.is_moe_layer`, else a dense SwiGLU on attention and Mamba layers when
d_ff > 0, else none (mLSTM and sLSTM layers carry their own projections).

Weights are stored in the dtype the reference casts them to where it uses
them: matrices in `layers.ACT_DTYPE` (read when the model is built), the
norms' scales, the vectors and the few matrices the reference uses in
float32 (`mamba.F32_WEIGHTS`, `xlstm.SLSTM_F32_WEIGHTS`) in float32.
Modes: `forward` for training (logits and the sum of the MoE layers' aux
losses), `prefill` -> caches, `decode_step` for serving (with `retrieved`
for the active-search long-context path on attention layers).  Decode
caches are the reference's layout, a list over period positions of dicts
keyed by the kind's state names (attention "k", "v"; Mamba "conv", "ssm";
mLSTM "c", "n"; sLSTM "h", "c", "n", "m"), each (n_repeat, B, ...), and
`decode_step` updates them IN PLACE (the reference donates them to its
step): a caller who reuses a cache clones it first.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.grid import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig

# the cores' weights stored in float32 though they have two or more dims
_F32_CORE = {"mamba": mam.F32_WEIGHTS, "slstm": xl.SLSTM_F32_WEIGHTS}
# the decode caches' states in ACT_DTYPE; every other state is float32
ACT_CACHE_KEYS = ("k", "v", "conv")


def _device(device) -> torch.device:
    """A "meta" device as it is (shapes only), else `resolve_device`."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def cache_dtype(key: str) -> torch.dtype:
    """The dtype of a decode-cache state, as the reference keeps it."""
    return L.ACT_DTYPE if key in ACT_CACHE_KEYS else torch.float32


class ParamTree(nn.Module):
    """A nested dict of weights as a module, indexed like the dict:
    tensors become Parameters (a matrix in ACT_DTYPE unless its name is in
    `f32`), dicts become ParamTrees, so the state-dict names are the
    reference's paths ("ffn.shared.wi")."""

    def __init__(self, tree: dict, f32=()):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, _param(value, key in f32))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _param(t: torch.Tensor, f32: bool = False) -> nn.Parameter:
    """A weight of >= 2 dims in ACT_DTYPE (unless `f32`); vectors stay float32."""
    return nn.Parameter(t.to(L.ACT_DTYPE) if t.dim() >= 2 and not f32 else t)


_CORE = {  # kind -> (training form, prefill, decode step)
    "mamba": (mam.mamba_block, mam.mamba_prefill, mam.mamba_decode_step),
    "mlstm": (xl.mlstm_block, xl.mlstm_prefill, xl.mlstm_decode_step),
    "slstm": (xl.slstm_block, xl.slstm_prefill, xl.slstm_decode_step),
}


class Layer(nn.Module):
    """One decoder layer: RMSNorm, the core (attention, Mamba, mLSTM or
    sLSTM), residual; then, where the layer has one, RMSNorm, the MLP (MoE
    or dense SwiGLU), residual.  `core` and `ffn` are ParamTrees keyed as
    the reference's param dicts."""

    def __init__(self, cfg: ModelConfig, p: int, weights: dict):
        super().__init__()
        self.kind = cfg.pattern[p]
        self.moe = cfg.is_moe_layer(p)
        self.norm1 = _param(weights["norm1"])
        self.core = ParamTree(weights["core"], _F32_CORE.get(self.kind, ()))
        self.norm2 = _param(weights["norm2"]) if "ffn" in weights else None
        self.ffn = ParamTree(weights["ffn"]) if "ffn" in weights else None

    def _mlp(self, cfg, x):
        """x + the MLP's output, and the MoE aux loss (None without one)."""
        if self.ffn is None:
            return x, None
        h2 = L.rms_norm(x, self.norm2, cfg.norm_eps)
        if self.moe:
            y, aux = moe_lib.moe_block(self.ffn, cfg, h2)
            return x + y, aux
        return x + L.swiglu(h2, self.ffn["wi"], self.ffn["wg"], self.ffn["wo"]), None

    def forward_train(self, cfg, x, positions):
        """-> (x, this layer's MoE aux loss or None)."""
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind == "attn":
            core = attn.attention_block(self.core, cfg, h, positions, chunk=cfg.policy.attn_chunk)
        else:
            core = _CORE[self.kind][0](self.core, cfg, h)
        return self._mlp(cfg, x + core)

    def prefill(self, cfg, x, positions, cache_len):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind == "attn":
            core, cache = attn.prefill_cache(self.core, cfg, h, positions, cache_len)
        else:
            core, cache = _CORE[self.kind][1](self.core, cfg, h)
        return self._mlp(cfg, x + core)[0], cache

    def decode(self, cfg, x, cache: dict, pos, retrieved=None):
        """One token; `cache` holds this layer's views of the stacked
        caches, and the new state is written into them."""
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind != "attn":
            core, new = _CORE[self.kind][2](self.core, cfg, h, cache)
            for key, value in new.items():
                cache[key].copy_(value)
        elif retrieved is not None:
            core, _ = attn.decode_attention_retrieved(self.core, cfg, h, cache, pos, *retrieved)
        else:
            core, _ = attn.decode_attention(self.core, cfg, h, cache, pos)
        return self._mlp(cfg, x + core)[0]


def _layer_weights(cfg: ModelConfig, p: int, gen: torch.Generator | None,
                   device: torch.device) -> dict:
    """The reference's `_init_layer` draws for period position `p`
    (float32) from `gen`, or with no generator empty tensors on `device`
    (a meta device, for a loader)."""
    d, kind = cfg.d_model, cfg.pattern[p]
    init = {"attn": attn.init_attention, "mamba": mam.init_mamba,
            "mlstm": xl.init_mlstm, "slstm": xl.init_slstm}[kind]
    w = {"norm1": torch.ones((d,), device=device), "core": init(gen, cfg, device)}
    if cfg.is_moe_layer(p):
        w["norm2"] = torch.ones((d,), device=device)
        w["ffn"] = moe_lib.init_moe(gen, cfg, device)
    elif cfg.d_ff > 0 and kind in ("attn", "mamba"):
        w["norm2"] = torch.ones((d,), device=device)
        w["ffn"] = L.init_mlp(gen, d, cfg.d_ff, device)
    return w


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded vocab rows can never win argmax / receive CE mass."""
    if cfg.vocab_eff == cfg.vocab_size:
        return logits
    col = torch.arange(cfg.vocab_eff, device=logits.device) < cfg.vocab_size
    return torch.where(col, logits, -1e30)


class DecoderLM(nn.Module):
    """The decoder LM of `cfg` on `device` (None = the card).

    Weights are drawn as the reference's `init_params` draws them (normal
    / sqrt(fan_in), embeddings normal * 0.02, norm scales 1) from
    `generator` (default: seed 0 on `device`); on a "meta" device nothing
    is drawn, for a loader (`convert.model_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, device=None, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device(device)
        if dev.type == "meta":
            generator = None
        elif generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"a generator on {generator.device} draws no weights on {dev}")
        self.cfg = cfg
        period = cfg.block_period
        self.layers = nn.ModuleList(
            Layer(cfg, i % period, _layer_weights(cfg, i % period, generator, dev))
            for i in range(cfg.n_layers))
        v, d = cfg.vocab_eff, cfg.d_model
        self.embed = _param(L.embed_init(generator, (v, d), dev))
        self.final_norm = nn.Parameter(torch.ones((d,), device=dev))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = _param(L.dense_init(generator, (d, v), device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return _mask_pad_vocab(self.cfg, torch.matmul(x, head.to(x.dtype)))

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        """Token embedding + modality frontend stubs."""
        cfg = self.cfg
        if cfg.frontend == "audio":
            # EnCodec frame embeddings arrive precomputed: (B, S, d)
            return batch["frame_embeds"].to(device=self.device, dtype=L.ACT_DTYPE)
        x = self.embed[batch["tokens"].to(self.device)].to(L.ACT_DTYPE)
        if cfg.frontend == "vision" and "vision_embeds" in batch:
            # patch embeddings occupy the first n_frontend_tokens positions
            ve = batch["vision_embeds"]
            x[:, :ve.shape[1]] = ve.to(device=self.device, dtype=L.ACT_DTYPE)
        return x

    def _trunk(self, batch: dict):
        """The training forward up to the final norm: (hidden states (B, S,
        d), the sum of the MoE layers' aux losses, float32)."""
        x = self.embed_inputs(batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, a = layer.forward_train(self.cfg, x, positions)
            if a is not None:
                aux = aux + a
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps), aux

    def hidden_states(self, batch: dict) -> torch.Tensor:
        """The final-normed hidden states (B, S, d) of the training forward."""
        return self._trunk(batch)[0]

    def forward(self, batch: dict):
        """Training forward: batch {tokens (B,S), ...} -> (logits (B,S,V),
        aux: the sum of the MoE layers' load-balancing losses)."""
        x, aux = self._trunk(batch)
        return self._logits(x), aux

    def loss_fn(self, batch: dict, aux_weight: float = 0.01):
        logits, aux = self(batch)
        mask = batch.get("mask")
        nll = L.softmax_cross_entropy(logits, batch["labels"].to(logits.device),
                                      None if mask is None else mask.to(logits.device))
        loss = nll + aux_weight * aux
        return loss, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------ serving ---

    def prefill(self, batch: dict, cache_len: int = 0):
        """-> (last-position logits (B, V), caches, last hidden (B, d)).
        caches: a list over period positions of the kind's states, each
        with a leading (n_repeat,) axis, the reference's layout."""
        x = self.embed_inputs(batch)
        s = x.shape[1]
        cache_len = cache_len or s
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        per_layer = []
        for layer in self.layers:
            x, cache = layer.prefill(self.cfg, x, positions, cache_len)
            per_layer.append(cache)
        period = self.cfg.block_period
        caches = [{key: torch.stack([c[key] for c in per_layer[p::period]])
                   for key in per_layer[p]} for p in range(period)]
        del per_layer
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        last = x[:, -1, :]
        return self._logits(last), caches, last

    def decode_step(self, caches: list, token: torch.Tensor, pos, retrieved: tuple | None = None):
        """One decode step -> (logits (B, V), caches, hidden (B, d)).
        token (B,) int; pos the write / attend position (tokens < pos+1
        valid); retrieved = (positions (B, m), valid (B, m), local_window).
        `caches` is updated in place and returned."""
        pos = int(pos)
        x = self.embed[token.to(self.device)][:, None, :].to(L.ACT_DTYPE)
        period = self.cfg.block_period
        for i, layer in enumerate(self.layers):
            cache = {key: state[i // period] for key, state in caches[i % period].items()}
            x = layer.decode(self.cfg, x, cache, pos, retrieved)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        hidden = x[:, 0, :]
        return self._logits(hidden), caches, hidden


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> list:
    """Empty decode caches with the structure `prefill` produces, on
    `device` (None = the card; "meta" for shapes only)."""
    dev = _device(device)
    caches = []
    for p in range(cfg.block_period):
        kind = cfg.pattern[p]
        if kind == "attn":
            shape = (batch, cache_len, cfg.hkv_eff, cfg.head_dim)
            c = {key: torch.zeros(shape, dtype=L.ACT_DTYPE, device=dev) for key in ("k", "v")}
        else:
            init = {"mamba": mam.init_mamba_cache, "mlstm": xl.init_mlstm_cache,
                    "slstm": xl.init_slstm_cache}[kind]
            c = init(cfg, batch, dev)
        caches.append({key: state.expand(cfg.n_repeat, *state.shape).clone()
                       for key, state in c.items()})
    return caches
