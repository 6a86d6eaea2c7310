"""Architecture + shape configuration (a copy of ``repro.configs.base``;
the port keeps its own so that it imports nothing of the JAX package).

Every assigned architecture is a frozen ArchConfig; ``pattern`` assigns a
block kind per layer ("attn" | "mamba" | "mlstm" | "slstm"), grouped into
superblocks of length ``sb`` for scan-over-layers (compile time stays
O(superblock), not O(n_layers)).

TP-16 alignment: head counts are padded up to a multiple of 16 where needed
(``n_heads_padded``), KV heads are replicated/padded to 16 slots when fewer
(``kv_sharded``/``n_kv_padded``), vocab is padded to a multiple of 16
(``vocab_padded``), expert counts padded to a multiple of 16
(``n_experts_padded``). All padding is zero-weight and is accounted in the
roofline's useful-FLOPs ratio (EXPERIMENTS.md).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # always-on shared experts (qwen2-moe)
    every: int = 1               # every k-th layer is MoE (jamba: 2)
    offset: int = 0              # first MoE layer index within the pattern


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = ()          # per-layer kinds; default all-attn
    sb: int = 0                  # superblock length (0 -> auto)
    moe: MoECfg | None = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: str = "rope"           # "rope" | "mrope" | "none"
    rope_theta: float = 1e4
    mrope_sections: tuple = (16, 24, 24)
    embed_input: bool = False    # modality frontend stub feeds embeddings
    norm_eps: float = 1e-6
    # ssm (jamba mamba blocks)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # xlstm
    xl_heads: int = 4
    parallel_block: bool = False  # attn+FFN from same input, one TP psum
    tp: int = 16                 # tensor-parallel width the padding targets
    tp_shard: bool = True        # False: replicate weights across model axis
    family: str = "dense"        # dense|moe|hybrid|vlm|audio|ssm
    subquadratic: bool = False   # eligible for long_500k

    # ---- derived ---------------------------------------------------------
    def __post_init__(self):
        if not self.pattern:
            object.__setattr__(self, "pattern", ("attn",) * self.n_layers)
        assert len(self.pattern) == self.n_layers
        if self.sb == 0:
            object.__setattr__(self, "sb", self._auto_sb())
        assert self.n_layers % self.sb == 0
        # superblocks must be identical so params can stack
        p = self.pattern
        for s in range(0, self.n_layers, self.sb):
            assert p[s:s + self.sb] == p[:self.sb], "pattern not periodic"

    def _auto_sb(self) -> int:
        p = self.pattern
        for sb in range(1, self.n_layers + 1):
            if self.n_layers % sb == 0 and all(
                    p[s:s + sb] == p[:sb]
                    for s in range(0, self.n_layers, sb)):
                return sb
        return self.n_layers

    @property
    def n_sb(self) -> int:
        return self.n_layers // self.sb

    @property
    def n_heads_padded(self) -> int:
        if not self.tp_shard:
            return self.n_heads
        return -(-self.n_heads // self.tp) * self.tp

    @property
    def kv_sharded(self) -> bool:
        """KV projections are TP-sharded when there are >= tp KV heads;
        otherwise the (small) KV projection is replicated across TP and each
        rank slices its q-head group's KV head — keeps GQA weight tying
        exact under training (no duplicated weight copies)."""
        return self.tp_shard and self.n_kv_heads >= self.tp

    @property
    def n_kv_padded(self) -> int:
        if self.kv_sharded:
            return -(-self.n_kv_heads // self.tp) * self.tp
        return self.n_kv_heads

    @property
    def vocab_padded(self) -> int:
        t = self.tp if self.tp_shard else 1
        step = t * 8
        return -(-self.vocab_size // step) * step

    @property
    def n_experts_padded(self) -> int:
        if self.moe is None:
            return 0
        if not self.tp_shard:
            return self.moe.n_experts
        return -(-self.moe.n_experts // self.tp) * self.tp

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    def moe_at(self, pos: int) -> bool:
        """Is layer position `pos` a MoE layer? (jamba: every 2nd, offset 1)"""
        if self.moe is None or self.d_ff == 0:
            return False
        return (pos % self.moe.every) == (self.moe.offset % self.moe.every)

    # parameter count (true, unpadded) for MODEL_FLOPS
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.head_dim
        total = 0 if self.embed_input else self.vocab_size * d
        total += self.vocab_size * d        # lm head
        for i, kind in enumerate(self.pattern):
            if kind == "attn":
                total += d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh)
                total += (self.n_heads * dh) * d
                total += 2 * d               # norms
            elif kind == "mamba":
                di, ds, dtr = self.d_inner, self.d_state, self.dt_rank
                total += d * 2 * di + di * self.d_conv + \
                    di * (dtr + 2 * ds) + dtr * di + di * ds + di + di * d + d
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * d + d * self.expand * d * 2 + 2 * d
            # ffn / moe
            if kind in ("attn", "mamba") and self.d_ff > 0:
                if self.moe is not None and self.moe_at(i):
                    e = self.moe.n_experts
                    k = self.moe.top_k if active_only else e
                    total += 3 * d * self.moe.d_expert * k
                    total += 3 * d * self.moe.d_expert * self.moe.n_shared
                    total += d * e           # router
                else:
                    total += 3 * d * self.d_ff
        return total


_REGISTRY = [
    "granite_moe_1b_a400m", "qwen2_moe_a2_7b", "jamba_v0_1_52b",
    "qwen1_5_4b", "command_r_plus_104b", "yi_9b", "qwen3_4b",
    "qwen2_vl_72b", "musicgen_large", "xlstm_125m",
]


def list_archs() -> list[str]:
    return list(_REGISTRY)


def single_card(cfg: ArchConfig) -> ArchConfig:
    """The one-card form of ``cfg``: no tensor parallelism, so every query
    head and every KV head is kept (qwen3-4b: 32 query heads over 8 KV
    heads, group size 4) and nothing is padded for a TP-16 mesh.  The
    published layout (``tp=16, tp_shard=True``) keeps, for an arch with
    fewer than 16 KV heads, one KV slot a rank: the KV head its block of
    query heads reads.  On a 16-wide ``model`` axis that is exact GQA
    where nothing is padded (qwen3-4b: rank r holds query heads 2r and 2r
    + 1 and KV head r // 2, the one-card form's function); on a
    one-position mesh it is a single KV head for every query head."""
    return replace(cfg, tp=1, tp_shard=False)


def get_arch(name: str) -> ArchConfig:
    mod = name.replace("-", "_").replace(".", "_")
    if mod not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {_REGISTRY}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
