"""Model configuration for the PyTorch port.

A copy of the reference package's `ModelConfig` (configs/base.py): the same
fields, the same derived properties the serving path reads, and the same
`reduced()` CPU-test shrink.  The port imports nothing from the JAX package,
so the dataclass lives here again; `tests/test_torch_lm.py` checks it field
for field against the original.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

Schedule = Tuple[Tuple[str, int], ...]

ATTN_KINDS = ("attn", "local", "moe", "moe_local", "hybrid_attn",
              "hybrid_local", "enc", "dec", "vit")
LOCAL_KINDS = ("local", "moe_local", "hybrid_local")
SSM_KINDS = ("ssm", "hybrid_attn", "hybrid_local")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | encdec | vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    schedule: Schedule
    # -- attention ----------------------------------------------------------
    sliding_window: int = 0
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    causal: bool = True
    # -- mlp / norm ---------------------------------------------------------
    mlp_act: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    # -- moe ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # -- ssm (mamba2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    conv_width: int = 4
    # -- encoder/decoder ----------------------------------------------------
    n_enc_layers: int = 0
    enc_schedule: Schedule = ()
    enc_seq: int = 0
    # -- vlm ----------------------------------------------------------------
    n_patches: int = 0
    # -- vit classifier -----------------------------------------------------
    n_classes: int = 0
    image_seq: int = 0
    # -- systems knobs ------------------------------------------------------
    attention_sharding: str = "head_tp"
    tie_embeddings: bool = False
    max_seq: int = 32_768

    @property
    def ssm_heads(self) -> int:
        di = self.d_inner or 2 * self.d_model
        return di // self.ssm_head_dim if self.ssm_state else 0

    @property
    def padded_vocab(self) -> int:
        """Vocabulary padded to a multiple of 256; padded logit columns are
        masked out in sampling."""
        return -(-self.vocab // 256) * 256 if self.vocab else 0

    def padded_ssm_heads(self, tp: int = 16) -> int:
        """SSM heads padded up to a multiple of `tp` (hymba: 50 -> 64); the
        pad heads' out-projection rows are zero, so the output is exact."""
        if not self.ssm_state:
            return 0
        h = self.ssm_heads
        return -(-h // tp) * tp if h % tp else h

    def padded_d_inner(self, tp: int = 16) -> int:
        return self.padded_ssm_heads(tp) * self.ssm_head_dim

    @property
    def has_ssm(self) -> bool:
        return any(k in SSM_KINDS for k, _ in self.schedule)

    def n_params(self) -> int:
        """Parameter count (embedding, blocks, unembedding) as the
        reference counts it, for the kinds the port serves: attention and
        SSM heads with a dense MLP, and the attention-free `ssm` block; a
        ViT counts its positions and classifier head instead of the
        vocabulary (as the reference does, not the patchify weight, the cls
        token or the head bias)."""
        E, F, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        total = V * E + (0 if self.tie_embeddings else E * V)
        if self.n_classes:
            total = self.image_seq * E + E * self.n_classes
        gated = 3 if self.mlp_act == "swiglu" else 2
        for kind, count in self.schedule:
            p = 2 * E
            if kind in ATTN_KINDS:
                p += E * (H * hd) + 2 * E * (KV * hd) + (H * hd) * E
            if kind in SSM_KINDS:
                di = self.d_inner or 2 * E
                nh = di // self.ssm_head_dim
                p += E * (2 * di + 2 * self.ssm_state + nh)
                p += di * self.conv_width + 2 * nh + di * E
            if kind != "ssm":
                p += gated * E * F
            total += p * count
        return total

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's shrink)."""
        def shrink(sched: Schedule, cap: int = 2) -> Schedule:
            return tuple((k, min(c, cap)) for k, c in sched[:3])
        hd = 16
        H = min(self.n_heads, 4) if self.n_heads else 0
        KV = max(1, min(self.n_kv_heads, 2)) if self.n_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=sum(c for _, c in shrink(self.schedule)),
            d_model=64,
            n_heads=H,
            n_kv_heads=KV,
            head_dim=hd,
            d_ff=128,
            vocab=256,
            schedule=shrink(self.schedule),
            enc_schedule=shrink(self.enc_schedule) if self.enc_schedule else (),
            n_enc_layers=(sum(c for _, c in shrink(self.enc_schedule))
                          if self.enc_schedule else 0),
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            d_inner=128 if self.ssm_state else 0,
            enc_seq=min(self.enc_seq, 12) if self.enc_seq else 0,
            n_patches=min(self.n_patches, 4) if self.n_patches else 0,
            n_classes=min(self.n_classes, 16) if self.n_classes else 0,
            image_seq=min(self.image_seq, 17) if self.image_seq else 0,
            max_seq=128,
        )


def uniform_schedule(kind: str, n: int) -> Schedule:
    return ((kind, n),)
