"""Config system: ModelConfig dataclass, input-shape registry, helpers.

Port of ``repro/configs/base.py`` with torch dtypes. Every architecture has
a ``configs/<id>.py`` exporting CONFIG; the registry in
``configs/__init__.py`` resolves ``--arch <id>``. Reduced smoke variants are
derived mechanically via ``reduce_for_smoke``.

The fields that steer sharding, remat or XLA's cost model in the
reference are kept so that a config means the same in both packages. The
port reads ``remat`` and ``remat_policy`` (a train-mode forward
checkpoints each layer, ``models/transformer.py``), ``parallelism`` (the
sharding rules, ``launch/sharding.py``) and the ``mesh_*`` fields that
``train.steps`` sets from its mesh (an MoE layer then routes each
data-parallel shard's tokens as its own group, as the reference does).
``unroll_layers``, ``attn_unroll``, ``ssm_unroll``, ``attn_shard`` and
``seq_parallel`` only steer XLA and its sharding constraints: nothing here
reads them.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduce_for_smoke", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    scale_embed: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    # attention pattern
    sliding_window: int = 0  # 0 = full attention
    global_every: int = 0  # gemma3: every Nth layer is global
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    # hybrid
    attn_every: int = 0  # zamba2: shared attn block after every N mamba layers
    # numerics / execution
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"
    attn_kv_chunk: int = 1024
    # decode budget: prefill pads its KV cache by this many slots
    cache_pad: int = 0
    # the reference's cost-model and sharding knobs (the mesh_* fields set
    # by train.steps give an MoE layer its groups; see the module docstring)
    unroll_layers: bool = False
    attn_unroll: bool = False
    ssm_unroll: bool = False
    attn_shard: str = "heads"
    parallelism: str = "2d"
    mesh_dp: tuple = ()
    mesh_model: str = ""
    mesh_model_size: int = 0
    mesh_axis_sizes: tuple = ()
    seq_parallel: bool = True
    # whether the modality frontend is a stub fed with embeddings
    embeds_input: bool = False
    # documentation: why long_500k is runnable / skipped
    subquadratic: bool = False

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    def param_count(self) -> int:
        """Total parameters (for 6ND roofline math)."""
        d, v, l = self.d_model, self.padded_vocab, self.num_layers
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        if self.family == "ssm":
            n += l * self._ssm_layer_params()
            return n
        if self.family == "hybrid":
            n += l * self._ssm_layer_params()
            n += self._attn_layer_params() + self._ffn_params()  # one shared block
            return n
        n += l * (self._attn_layer_params() + self._ffn_params())
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.num_layers
        inactive = l * (self.num_experts - self.top_k) * 3 * d * f
        return self.param_count() - inactive

    def _attn_layer_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        return d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d

    def _ffn_params(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.num_experts:
            n = self.num_experts * 3 * d * f + d * self.num_experts
            if self.dense_residual:
                n += 3 * d * f
            return n
        return 3 * d * f

    def _ssm_layer_params(self) -> int:
        from repro_torch.models.ssm import ssm_dims

        dims = ssm_dims(self.d_model, self.ssm_expand, self.ssm_headdim, self.ssm_state, self.ssm_conv)
        return (
            self.d_model * dims["d_in_proj"]
            + dims["conv_k"] * dims["conv_dim"] + dims["conv_dim"]
            + 3 * dims["nheads"]
            + dims["d_inner"]
            + dims["d_inner"] * self.d_model
            + self.d_model
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        num_layers=max(2, (cfg.attn_every or 2)),
        d_model=128,
        d_ff=0 if cfg.family == "ssm" else 256,
        vocab_size=512,
        head_dim=32,
        remat=False,
        attn_kv_chunk=64,
        ssm_chunk=32,
        cache_pad=16,
        dtype=torch.float32,
        param_dtype=torch.float32,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4
    if cfg.num_experts:
        kw["num_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
        # drop-free routing so decode-vs-full consistency is exact in tests
        kw["capacity_factor"] = 8.0
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_headdim"] = 16
        kw["ssm_expand"] = 2
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["num_layers"] = 4
    if cfg.global_every:
        kw["global_every"] = 2
    return dataclasses.replace(cfg, **kw)
