"""Assigned input shapes and their stand-ins.

Port of `repro/configs/shapes.py`.  Four shapes per LM architecture:
  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768  global_batch 128   -> decode step (1 token, full cache)
  long_500k    seq 524,288 global_batch 1     -> decode step; needs sub-quadratic
               attention: native for ssm/hybrid, active-search retrieval memory
               for the beyond-paper cells, SKIP for pure full-attention archs.

Where the reference returns `jax.ShapeDtypeStruct`s, the port returns
tensors on the "meta" device: shapes and dtypes, no memory, so the full
configs never allocate.  `decode_specs` builds its caches with the port's
`init_caches`, every layer kind's states in the reference's dtypes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Model-input stand-ins for train/prefill (tokens + frontends)."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {
        "tokens": _sds((b, s), torch.int32),
        "labels": _sds((b, s), torch.int32),
    }
    if cfg.frontend == "audio":
        # EnCodec frame embeddings arrive precomputed (a frontend stub)
        specs["frame_embeds"] = _sds((b, s, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision":
        specs["vision_embeds"] = _sds((b, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Decode-step inputs: one new token against a seq_len cache."""
    b, s = shape.global_batch, shape.seq_len
    return {
        "caches": M.init_caches(cfg, b, s, device="meta"),
        "token": _sds((b,), torch.int32),
        "pos": _sds((), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return batch_specs(cfg, shape)
