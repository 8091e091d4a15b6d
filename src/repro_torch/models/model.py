"""Decoder LM: the reference's composition for its attention-only
architectures, as `nn.Module`s.

Port of `repro/models/model.py`.  The reference stores its layers stacked
by period position (`params["blocks"][p]`, a leading (n_repeat,) axis) so
that `lax.scan` runs them; here `DecoderLM.layers` is an `nn.ModuleList`
in layer order (layer i = repeat i // period, position i % period), run
by a Python loop.  `convert.model_from_numpy` loads the reference's
`init_params` tree into it.

Every layer must be an attention layer with a dense SwiGLU MLP (or none):
a Mamba, mLSTM or sLSTM layer, or an MoE MLP, raises NotImplementedError
(ROADMAP A6.2: `models/mamba.py`, `xlstm.py` and `moe.py` are not ported).
That covers minitron-8b, stablelm-12b, stablelm-3b, internlm2-1.8b,
internvl2-1b and musicgen-medium (the last two through their frontend
stubs).

Weights of two or more dims are stored in `layers.ACT_DTYPE` (read when
the model is built), the norms' scales in float32.  Modes: `forward` for
training, `prefill` -> caches, `decode_step` for serving (with
`retrieved` for the active-search long-context path).  Decode caches are
the reference's layout, a list over period positions of {"k", "v"}
tensors (n_repeat, B, T, Hkv, hd), and `decode_step` updates them IN
PLACE (the reference donates them to its step): a caller who reuses a
cache clones it first.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.grid import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _device(device) -> torch.device:
    """A "meta" device as it is (shapes only), else `resolve_device`."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port's model has attention layers with a dense MLP only; "
        "Mamba, xLSTM and MoE layers are ROADMAP A6.2 (models/mamba.py, "
        "xlstm.py, moe.py), not ported yet"
    )


def _check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of `cfg` is one the
    port computes (attention, dense MLP)."""
    for p in range(cfg.block_period):
        if cfg.pattern[p] != "attn":
            raise _unported(f"{cfg.name}: a {cfg.pattern[p]!r} layer")
        if cfg.is_moe_layer(p):
            raise _unported(f"{cfg.name}: an MoE layer")


def _param(t: torch.Tensor) -> nn.Parameter:
    """A weight of >= 2 dims in ACT_DTYPE; a norm scale stays float32."""
    return nn.Parameter(t.to(L.ACT_DTYPE) if t.dim() >= 2 else t)


class Layer(nn.Module):
    """One decoder layer: RMSNorm, attention, residual; RMSNorm, SwiGLU,
    residual (no MLP when d_ff == 0).  `core` and `ffn` are ParameterDicts
    keyed as the reference's param dicts."""

    def __init__(self, weights: dict):
        super().__init__()
        self.norm1 = _param(weights["norm1"])
        self.core = nn.ParameterDict({k: _param(v) for k, v in weights["core"].items()})
        self.norm2 = _param(weights["norm2"]) if "ffn" in weights else None
        self.ffn = (nn.ParameterDict({k: _param(v) for k, v in weights["ffn"].items()})
                    if "ffn" in weights else None)

    def _mlp(self, cfg, x):
        if self.ffn is None:
            return x
        h2 = L.rms_norm(x, self.norm2, cfg.norm_eps)
        return x + L.swiglu(h2, self.ffn["wi"], self.ffn["wg"], self.ffn["wo"])

    def forward_train(self, cfg, x, positions):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        x = x + attn.attention_block(self.core, cfg, h, positions, chunk=cfg.policy.attn_chunk)
        return self._mlp(cfg, x)

    def prefill(self, cfg, x, positions, cache_len):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        core, cache = attn.prefill_cache(self.core, cfg, h, positions, cache_len)
        return self._mlp(cfg, x + core), cache

    def decode(self, cfg, x, cache, pos, retrieved=None):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if retrieved is not None:
            core, _ = attn.decode_attention_retrieved(self.core, cfg, h, cache, pos, *retrieved)
        else:
            core, _ = attn.decode_attention(self.core, cfg, h, cache, pos)
        return self._mlp(cfg, x + core)


def _layer_weights(cfg: ModelConfig, gen: torch.Generator | None, device: torch.device) -> dict:
    """The reference's `_init_layer` draws for an attention layer (float32)
    from `gen`, or with no generator empty tensors on `device` (a meta
    device, for a loader)."""
    d = cfg.d_model
    w = {"norm1": torch.ones((d,), device=device),
         "core": attn.init_attention(gen, cfg, device)}
    if cfg.d_ff > 0:
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
        _check_supported(cfg)
        dev = _device(device)
        if dev.type == "meta":
            generator = None
        elif generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"a generator on {generator.device} draws no weights on {dev}")
        self.cfg = cfg
        self.layers = nn.ModuleList(
            Layer(_layer_weights(cfg, generator, dev)) for _ in range(cfg.n_layers))
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

    def hidden_states(self, batch: dict) -> torch.Tensor:
        """The final-normed hidden states (B, S, d) of the training forward."""
        x = self.embed_inputs(batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for layer in self.layers:
            x = layer.forward_train(self.cfg, x, positions)
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def forward(self, batch: dict):
        """Training forward: batch {tokens (B,S), ...} -> (logits (B,S,V), aux)."""
        x = self.hidden_states(batch)
        return self._logits(x), torch.zeros((), dtype=torch.float32, device=x.device)

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
        caches: a list over period positions of {"k", "v"} with a leading
        (n_repeat,) axis, the reference's layout."""
        x = self.embed_inputs(batch)
        s = x.shape[1]
        cache_len = cache_len or s
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        per_layer = []
        for layer in self.layers:
            x, cache = layer.prefill(self.cfg, x, positions, cache_len)
            per_layer.append(cache)
        period = self.cfg.block_period
        caches = [{key: torch.stack([c[key] for c in per_layer[p::period]]) for key in ("k", "v")}
                  for p in range(period)]
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
            c = caches[i % period]
            cache = {"k": c["k"][i // period], "v": c["v"][i // period]}
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
        if cfg.pattern[p] != "attn":
            raise _unported(f"{cfg.name}: a {cfg.pattern[p]!r} layer's decode cache")
        shape = (cfg.n_repeat, batch, cache_len, cfg.hkv_eff, cfg.head_dim)
        caches.append({key: torch.zeros(shape, dtype=L.ACT_DTYPE, device=dev) for key in ("k", "v")})
    return caches
