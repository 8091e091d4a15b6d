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
Modes: `forward` (logits and the sum of the MoE layers' aux losses; the
module form of the training forward, kept as the serving model's own
reference for its prefill and decode), `prefill` -> caches, `decode_step`
for serving (with `retrieved` for the
active-search long-context path on attention layers).  Training runs on
the reference's parameter tree instead of a module (`init_params`,
`compute_copy`, `forward_params`, `loss_params`, at the end of this
file): float32 masters stacked by period position, through the same
per-layer functions (`layer_train`), each period-repeat of layers under
the config's remat policy.

Decode caches are the reference's layout, a list over period positions
of dicts keyed by the kind's state names (attention "k", "v"; Mamba
"conv", "ssm"; mLSTM "c", "n"; sLSTM "h", "c", "n", "m"), each
(n_repeat, B, ...), and `decode_step` updates them IN PLACE (the
reference donates them to its step): a caller who reuses a cache clones
it first.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                   create_selective_checkpoint_contexts)

from repro_torch.core.grid import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.axes import constrain, current_rules, restored_rules
from repro_torch.utils import tree

# the cores' weights stored in float32 though they have two or more dims
_F32_CORE = {"mamba": mam.F32_WEIGHTS, "slstm": xl.SLSTM_F32_WEIGHTS}
# the decode caches' states in ACT_DTYPE; every other state is float32
ACT_CACHE_KEYS = ("k", "v", "conv")


def _generator(dev: torch.device, generator: torch.Generator | None):
    """The generator weights are drawn from on `dev`: none on a "meta"
    device, seed 0 on `dev` by default."""
    if dev.type == "meta":
        return None
    if generator is None:
        return torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"a generator on {generator.device} draws no weights on {dev}")
    return generator


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


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y pinned batch-sharded between sublayers (the reference's
    `constrain(x + y, "batch", "seq", "embed")`)."""
    return constrain(x + y, "batch", "seq", "embed")


def core_residual(cfg: ModelConfig, p: int, w, x, positions) -> torch.Tensor:
    """x + the core (attention, Mamba, mLSTM or sLSTM) of the layer at
    period position `p` with weights `w` (a mapping keyed as the
    reference's layer dict: "norm1", "core", and "norm2" / "ffn" where the
    layer has an MLP), in its training form."""
    kind = cfg.pattern[p]
    h = L.rms_norm(x, w["norm1"], cfg.norm_eps)
    if kind == "attn":
        return _residual(x, attn.attention_block(w["core"], cfg, h, positions,
                                                 chunk=cfg.policy.attn_chunk))
    return _residual(x, _CORE[kind][0](w["core"], cfg, h))


def mlp_residual(cfg: ModelConfig, p: int, w, x):
    """x + the MLP (MoE or dense SwiGLU) of the layer at period position
    `p`, and the MoE aux loss (None without one); x as it is where the
    layer has no MLP."""
    if "ffn" not in w:
        return x, None
    h2 = L.rms_norm(x, w["norm2"], cfg.norm_eps)
    f = w["ffn"]
    if cfg.is_moe_layer(p):
        y, aux = moe_lib.moe_block(f, cfg, h2)
        return _residual(x, y), aux
    return _residual(x, L.swiglu(h2, f["wi"], f["wg"], f["wo"])), None


def layer_train(cfg: ModelConfig, p: int, w, x, positions):
    """One layer of the training forward -> (x, its MoE aux loss or None)."""
    return mlp_residual(cfg, p, w, core_residual(cfg, p, w, x, positions))


class Layer(nn.Module):
    """One decoder layer: RMSNorm, the core (attention, Mamba, mLSTM or
    sLSTM), residual; then, where the layer has one, RMSNorm, the MLP (MoE
    or dense SwiGLU), residual.  `core` and `ffn` are ParamTrees keyed as
    the reference's param dicts, and the layer is indexed like the
    reference's layer dict (`layer["norm1"]`, `"ffn" in layer`)."""

    def __init__(self, cfg: ModelConfig, p: int, weights: dict):
        super().__init__()
        self.p = p
        self.kind = cfg.pattern[p]
        self.norm1 = _param(weights["norm1"])
        self.core = ParamTree(weights["core"], _F32_CORE.get(self.kind, ()))
        self.norm2 = _param(weights["norm2"]) if "ffn" in weights else None
        self.ffn = ParamTree(weights["ffn"]) if "ffn" in weights else None

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return getattr(self, key, None) is not None

    def prefill(self, cfg, x, positions, cache_len):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind == "attn":
            core, cache = attn.prefill_cache(self.core, cfg, h, positions, cache_len)
        else:
            core, cache = _CORE[self.kind][1](self.core, cfg, h)
        return mlp_residual(cfg, self.p, self, _residual(x, core))[0], cache

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
        return mlp_residual(cfg, self.p, self, _residual(x, core))[0]


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


def head_logits(cfg: ModelConfig, embed, lm_head, x: torch.Tensor) -> torch.Tensor:
    """The LM head's logits of final-normed x: x @ lm_head, or x @ embed.T
    with tied embeddings; padded vocab rows masked."""
    head = embed.T if cfg.tie_embeddings else lm_head
    return _mask_pad_vocab(cfg, torch.matmul(x, head.to(x.dtype)))


def embed_inputs(cfg: ModelConfig, embed, batch: dict) -> torch.Tensor:
    """Token embedding + modality frontend stubs, on `embed`'s device."""
    dev = embed.device
    if cfg.frontend == "audio":
        # EnCodec frame embeddings arrive precomputed: (B, S, d)
        return constrain(batch["frame_embeds"].to(device=dev, dtype=L.ACT_DTYPE),
                         "batch", "seq", "embed")
    x = L.embed_lookup(embed, batch["tokens"].to(dev)).to(L.ACT_DTYPE)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        # patch embeddings occupy the first n_frontend_tokens positions
        ve = batch["vision_embeds"]
        x[:, :ve.shape[1]] = ve.to(device=dev, dtype=L.ACT_DTYPE)
    return constrain(x, "batch", "seq", "embed")


class DecoderLM(nn.Module):
    """The decoder LM of `cfg` on `device` (None = the card).

    Weights are drawn as the reference's `init_params` draws them (normal
    / sqrt(fan_in), embeddings normal * 0.02, norm scales 1) from
    `generator` (default: seed 0 on `device`); on a "meta" device nothing
    is drawn, for a loader (`convert.model_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, device=None, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device(device)
        generator = _generator(dev, generator)
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
        return head_logits(self.cfg, self.embed, self.lm_head, x)

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        """Token embedding + modality frontend stubs."""
        return embed_inputs(self.cfg, self.embed, batch)

    def _trunk(self, batch: dict):
        """The training forward up to the final norm: (hidden states (B, S,
        d), the sum of the MoE layers' aux losses, float32)."""
        period = self.cfg.block_period
        repeats = [self.layers[r * period:(r + 1) * period] for r in range(self.cfg.n_repeat)]
        x, aux = _trunk(self.cfg, self.embed_inputs(batch), repeats, "none")
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps), aux

    def hidden_states(self, batch: dict) -> torch.Tensor:
        """The final-normed hidden states (B, S, d) of the training forward."""
        return self._trunk(batch)[0]

    def forward(self, batch: dict):
        """Training forward: batch {tokens (B,S), ...} -> (logits (B,S,V),
        aux: the sum of the MoE layers' load-balancing losses)."""
        x, aux = self._trunk(batch)
        return self._logits(x), aux

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
        return constrain(self._logits(last), "batch", "vocab"), caches, last

    def decode_step(self, caches: list, token: torch.Tensor, pos, retrieved: tuple | None = None):
        """One decode step -> (logits (B, V), caches, hidden (B, d)).
        token (B,) int; pos the write / attend position (tokens < pos+1
        valid); retrieved = (positions (B, m), valid (B, m), local_window).
        `caches` is updated in place and returned."""
        pos = int(pos)
        x = L.embed_lookup(self.embed, token.to(self.device))[:, None, :].to(L.ACT_DTYPE)
        period = self.cfg.block_period
        for i, layer in enumerate(self.layers):
            cache = {key: state[i // period] for key, state in caches[i % period].items()}
            x = layer.decode(self.cfg, x, cache, pos, retrieved)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        hidden = x[:, 0, :]
        return constrain(self._logits(hidden), "batch", "vocab"), caches, hidden


def model_from_params(cfg: ModelConfig, params: dict) -> DecoderLM:
    """A serving DecoderLM holding the weights of a train state's params
    (the `init_params` tree: float32 masters stacked by period position),
    each rounded to the model's storage dtype for it.  Plain tensors or
    DTensors: a DTensor weight stays placed as its leaf (the stack axis
    dropped), so the model serves on that leaf's mesh."""
    model = DecoderLM(cfg, device="meta")
    period = cfg.block_period
    for name, meta in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        if owner.startswith("layers."):
            _, i, *path = name.split(".")
            value = params["blocks"][int(i) % period]
            for key in path:
                value = value[key]
            value = value[int(i) // period]
        else:
            value = params[name]
        module = model.get_submodule(owner) if owner else model
        module._parameters[leaf] = nn.Parameter(value.to(meta.dtype).clone(), requires_grad=False)
    return model


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


# ------------------------------------------------------------- training ---
#
# The train step works on the reference's parameter tree, not on a
# DecoderLM: {"embed", "final_norm", "blocks", "lm_head"} with
# `blocks[p]` the nested dict of period position p's weights, every leaf
# with a leading (n_repeat,) axis, all float32 (the optimizer's masters).
# The per-layer functions above run on a repeat's slice of it, so the
# training forward is the serving model's forward, layer for layer.


def _loss(out, batch: dict, aux_weight: float):
    logits, aux = out
    mask = batch.get("mask")
    nll = L.softmax_cross_entropy(logits, batch["labels"].to(logits.device),
                                  None if mask is None else mask.to(logits.device))
    loss = nll + aux_weight * aux
    return loss, {"nll": nll, "aux": aux}


def init_params(cfg: ModelConfig, device=None, generator: torch.Generator | None = None,
                local=None) -> dict:
    """The reference's `init_params` tree in float32 on `device` (None =
    the card; "meta" for shapes only), layers stacked by period position.
    The weights are drawn from `generator` (default: seed 0 on `device`)
    in DecoderLM's order, so a DecoderLM built from the same generator
    holds the same numbers (rounded to its storage dtypes).  `local(path,
    leaf)`, where given, maps each drawn leaf (a layer's without its stack
    axis, at its stacked path) to the part kept, one layer at a time (a
    rank of a mesh keeps its shards and never holds the whole tree)."""
    dev = _device(device)
    gen = _generator(dev, generator)
    keep = local or (lambda path, leaf: leaf)
    period, n_rep = cfg.block_period, cfg.n_repeat
    blocks: list = [None] * period
    for i in range(cfg.n_layers):
        p, r = i % period, i // period
        w = tree.map_with_path(lambda path, a: keep(("blocks", p) + path, a),
                               _layer_weights(cfg, p, gen, dev))
        if blocks[p] is None:
            blocks[p] = tree.map(lambda a: torch.empty((n_rep, *a.shape), dtype=a.dtype,
                                                       device=dev), w)
        tree.map(lambda stack, a: stack[r].copy_(a), blocks[p], w)
        del w
    v, d = cfg.vocab_eff, cfg.d_model
    params = {"embed": keep(("embed",), L.embed_init(gen, (v, d), dev)),
              "final_norm": keep(("final_norm",), torch.ones((d,), device=dev)), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",), L.dense_init(gen, (d, v), device=dev))
    return params


def compute_copy(params: dict) -> dict:
    """The reference's compute copy: every float32 leaf of two or more
    dims in bf16, the rest as it is.  On the stacked tree every block leaf
    has the (n_repeat,) axis, so every one of them (norms, biases, `A_log`
    and `D` too) is rounded, with `embed` and `lm_head`; only `final_norm`
    stays float32.  Differentiable: the gradient of a master comes back
    through the cast, rounded to bf16 as the reference's does."""
    return tree.map(lambda p: p.to(torch.bfloat16)
                    if p.dtype == torch.float32 and p.dim() >= 2 else p, params)


def _mm_saveable(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of the unbatched matrix products (a 2-D
    `mm`: the projections and MLPs, which `torch.matmul` folds to 2-D),
    recompute the rest (the batched attention and expert products too)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """The reference's `_remat` on a period-repeat of layers: "none" runs
    `fn` as it is; "full" keeps only its inputs and recomputes the rest in
    the backward; "dots" keeps the unbatched matrix products' outputs (the
    reference's `dots_with_no_batch_dims_saveable`) through a selective
    checkpoint.  No mode changes a number."""
    if remat == "none":
        return fn
    kwargs = {"use_reentrant": False}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _mm_saveable)
    elif remat != "full":
        raise ValueError(f"remat must be 'none', 'full' or 'dots', not {remat!r}")

    def run(*args):
        # the recompute runs in the backward, maybe on autograd's device
        # thread: it takes the axis rules of the forward with it
        rules = current_rules()

        def body(*a):
            with restored_rules(rules):
                return fn(*a)

        return checkpoint(body, *args, **kwargs)

    return run


def _repeats(block: dict, n_repeat: int) -> list:
    """A stacked block's n_repeat slices (one `unbind` per leaf, so the
    backward stacks each leaf's gradient once)."""
    parts = _unbind(block)
    return [_pick(parts, r) for r in range(n_repeat)]


def _unbind(block: dict) -> dict:
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in block.items()}


def _pick(parts: dict, r: int) -> dict:
    return {k: _pick(v, r) if isinstance(v, dict) else v[r] for k, v in parts.items()}


def _trunk(cfg: ModelConfig, x: torch.Tensor, repeats: list, remat: str):
    """The training forward's layers over the embedded x: `repeats` holds
    each period-repeat's layer weights (a list over period positions of
    mappings keyed as the reference's layer dict), each repeat run under
    `_remat` -> (x, the sum of the MoE layers' aux losses, float32)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(x, blk):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, w in enumerate(blk):
            x, a = layer_train(cfg, p, w, x, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    run = _remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in repeats:
        x, a = run(x, blk)
        aux = aux + a
    return x, aux


def forward_params(cfg: ModelConfig, params: dict, batch: dict, remat: str | None = None):
    """The reference's training `forward` on its parameter tree: batch
    {tokens (B, S), ...} -> (logits (B, S, V), the MoE layers' aux loss).
    Each period-repeat of layers runs under `_remat` (`remat`, default
    `cfg.policy.remat`)."""
    remat = cfg.policy.remat if remat is None else remat
    period = cfg.block_period
    slices = [_repeats(params["blocks"][p], cfg.n_repeat) for p in range(period)]
    repeats = [[slices[p][r] for p in range(period)] for r in range(cfg.n_repeat)]
    x, aux = _trunk(cfg, embed_inputs(cfg, params["embed"], batch), repeats, remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(cfg, params["embed"], params.get("lm_head"), x)
    return constrain(logits, "batch", "seq", "vocab"), aux


def loss_params(cfg: ModelConfig, params: dict, batch: dict, aux_weight: float = 0.01,
                remat: str | None = None):
    """The reference's `loss_fn`: (nll + aux_weight * aux, {"nll", "aux"})."""
    return _loss(forward_params(cfg, params, batch, remat), batch, aux_weight)
