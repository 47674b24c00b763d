"""Model / data / decode configuration with the dataset presets.

The port's own copy of ``icek_tpu/core/config.py``: the same dataclasses
and preset values, so a configuration means the same model in both
packages.  Knobs that only select TPU-tuned strategies are left out; the
kernel switches default to ``None`` = on for CUDA tensors, off on CPU
(see ``decode/beam.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference: */train.py:27-38, */models.py)."""

    variant: str  # "geo" | "knowledge" | "news"
    emb_dim: int = 300              # d_model (word/entity/fact embedding dim)
    decoder_ffn_dim: int = 512      # FFN width in the transformer decoder
    encoder_ffn_dim: int = 512      # FFN width in the context transformer encoders
    num_heads: int = 10             # heads per transformer layer (head_dim 30)
    num_layers: int = 3             # transformer layers (decoder and ctx encoders)
    dropout_dec: float = 0.2
    dropout_enc: float = 0.2
    dropout_pos: float = 0.1
    encoded_image_size: int = 14    # 14x14 grid -> 196 image tokens
    image_encoder_dim: int = 2048   # ResNet-101 final channel count
    type_vocab: int = 1000          # entity type-embedding rows
    # Leading hand-crafted feature dims of the entity vector (geo: 4 =
    # dist/az_north/az_east/size; knowledge: 6; news: 5).
    num_entity_feature_dims: int = 4
    num_predicates: int = 0         # 0 disables the fact path (geo variant)
    entity_name_embedding: bool = False   # news only
    max_pos_len: int = 5000
    # Context-encoder attention through the flash-attention kernel
    # (kernels/flash_attention.py).  None = on for CUDA tensors, off on CPU.
    use_flash_attention: Optional[bool] = None

    @property
    def has_facts(self) -> bool:
        return self.num_predicates > 0

    @property
    def type_emb_dim(self) -> int:
        return self.emb_dim - self.num_entity_feature_dims


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Offline prep + loader settings (reference: */create_input_files.py)."""

    base_name: str
    entity_context_size: int         # E (stored arrays have E+1 rows incl <unk_ent>)
    fact_context_size: int = 0       # F (0 = no facts); stored arrays have F+1 rows
    max_caption_len: int = 30
    min_word_freq: int = 0
    img_size: int = 256
    entity_feature_cols: Tuple[str, ...] = ("distance", "azimuth", "size", "type_index")
    entity_random_ranges: Tuple[Tuple[float, float], ...] = (
        (0.0, 1.0), (-179.0, 179.0), (0.0, 0.1), (0, 500),
    )
    fact_feature_cols: Tuple[str, ...] = ()
    fact_random_ranges: Tuple[Tuple[float, float], ...] = ()
    name_col: str = "name"
    pack_name_word_ids: bool = False
    max_name_part_count: int = 5
    split_tokens_on_underscore: bool = False
    fold_entity_names_into_wordmap: bool = False
    # stream batches from the HDF5 sidecar store instead of loading the
    # JSON/pkl sidecars into host RAM (data/streaming.py); image tokens
    # cache to disk
    streaming: bool = False

    @property
    def num_entity_rows(self) -> int:
        return self.entity_context_size + 1

    @property
    def num_fact_rows(self) -> int:
        return self.fact_context_size + 1 if self.fact_context_size else 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-driver settings (reference: */train.py:40-54)."""

    epochs: int = 120
    batch_size: int = 4
    encoder_lr: float = 1e-4
    decoder_lr: float = 4e-4
    grad_clip: float = 5.0           # per-element clamp, not a norm clip
    max_epochs_since_improvement: int = 20
    lr_decay_every: int = 8
    lr_decay_factor: float = 0.8
    fine_tune_encoder: bool = False
    # Opt-in reproduction of the reference's frozen-encoder side effect
    # (geo-aware/train.py:245 calls encoder.train()): batch norm normalizes
    # by batch statistics and updates the running buffers every step.
    bn_train_mode: bool = False
    print_freq: int = 100
    seed: int = 0
    # dtype of the model's matmuls in a training run on the card: "bfloat16"
    # or "float32" (train/loop.py::train); the CPU always computes in float32
    compute_dtype: str = "bfloat16"
    # Microbatches per step (gradients of the summed NLL accumulate, one
    # optimizer step).  "auto" resolves to 1 until an accumulation table has
    # been measured on the H100 (train/step.py::resolve_grad_accum).
    grad_accum_steps: object = "auto"
    # Keep the train split's cached image tokens on the card when they fit
    # this budget (GiB); batches then carry row ids and the step gathers
    # the tokens on the device.  0 disables.  Frozen-encoder training only.
    device_token_cache_gb: float = 4.0
    # Also write the rolling mid-epoch STEP checkpoint every N train batches
    # (0 = epoch boundaries only); resume re-enters the epoch at the next
    # batch, bit-identical to an uninterrupted run.
    checkpoint_every_steps: int = 0
    # Catch SIGTERM during training (on the main thread): finish the step in
    # flight, write the STEP checkpoint, return with `preempted`.
    save_on_preempt: bool = True


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Inference settings (reference: */eval.py)."""

    max_caption_len: int = 30
    beam_size: int = 5               # 1 = greedy
    batch_size: Optional[int] = None     # None = 256 on CUDA, 64 on CPU
    # Kernel switches; None = on for CUDA tensors, off on CPU.  False
    # selects the stock torch path.
    use_megakernel: Optional[bool] = None
    use_fused_scores: Optional[bool] = None
    # None = float KV caches; "int8" quantizes the self caches and the cross
    # K/V, "int8_cross" only the cross K/V (both run the plain decoder step);
    # "auto" = None on every device (decode/beam.py::resolve_kv_dtype).
    kv_dtype: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    model: ModelConfig
    data: DataConfig
    train: TrainConfig
    decode: DecodeConfig

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def georic() -> Config:
    """geo-aware preset (reference: geo-aware/train.py, create_input_files.py:341-356)."""
    return Config(
        name="georic",
        model=ModelConfig(
            variant="geo",
            type_vocab=1000,
            num_entity_feature_dims=4,
            num_predicates=0,
        ),
        data=DataConfig(
            base_name="geo_aware_georic2",
            entity_context_size=300,
            fact_context_size=0,
            max_caption_len=30,
            min_word_freq=0,
        ),
        train=TrainConfig(batch_size=4),
        decode=DecodeConfig(max_caption_len=30),
    )


def k_georic() -> Config:
    """knowledge-aware preset (reference: knowledge-aware/train.py,
    create_input_files.py:58-62,164-190)."""
    return Config(
        name="k_georic",
        model=ModelConfig(
            variant="knowledge",
            type_vocab=1000,
            num_entity_feature_dims=6,
            num_predicates=3000,
        ),
        data=DataConfig(
            base_name="knowledge_from_metadata",
            entity_context_size=300,
            fact_context_size=50,
            max_caption_len=100,
            min_word_freq=0,
            entity_random_ranges=((0.0, 10.0), (-179.0, 179.0), (0.0, 0.1), (0, 500)),
            fact_feature_cols=("subject_idx_in_entity_context", "predicate_idx"),
            fact_random_ranges=((300, 300), (0, 0)),
        ),
        train=TrainConfig(batch_size=4),
        decode=DecodeConfig(max_caption_len=40),
    )


def nytimes800k() -> Config:
    """news-knowledge-aware preset (reference: news-knowledge-aware/train.py,
    create_input_files.py:58-62,165-191)."""
    return Config(
        name="nytimes800k",
        model=ModelConfig(
            variant="news",
            type_vocab=20,
            num_entity_feature_dims=5,
            num_predicates=3500,
            entity_name_embedding=True,
        ),
        data=DataConfig(
            base_name="knowledge_from_metadata_nytimes",
            entity_context_size=100,
            fact_context_size=300,
            max_caption_len=50,
            min_word_freq=5,
            entity_feature_cols=(
                "count", "in_headline", "in_first_paragraph", "type", "name_processed",
            ),
            entity_random_ranges=((0, 0), (0, 0), (0, 0), (0, 0), (0, 0)),
            fact_feature_cols=("subject_idx_in_entity_context", "predicate_idx"),
            fact_random_ranges=((100, 100), (0, 0)),
            name_col="name_processed",
            pack_name_word_ids=True,
            split_tokens_on_underscore=True,
            fold_entity_names_into_wordmap=True,
        ),
        train=TrainConfig(batch_size=3),
        decode=DecodeConfig(max_caption_len=40),
    )


def geometry_of(cfg: Config) -> str:
    return f"{cfg.model.emb_dim}x{cfg.model.num_heads}"


def apply_geometry(cfg: Config, geometry: str) -> Config:
    """Replace the transformer geometry ``"<emb_dim>x<num_heads>"`` for
    from-scratch training.  The packed input files do not depend on it;
    checkpoints record it and eval / serve re-apply it.  Not checkpoint
    parity with the reference, which needs 300x10."""
    try:
        emb_dim, num_heads = (int(v) for v in geometry.lower().split("x"))
    except ValueError:
        raise ValueError(f"geometry must be '<emb_dim>x<num_heads>', got {geometry!r}")
    if emb_dim <= 0 or num_heads <= 0 or emb_dim % num_heads:
        raise ValueError(f"geometry {geometry!r}: emb_dim must be a positive multiple "
                         f"of num_heads")
    if emb_dim <= cfg.model.num_entity_feature_dims:
        raise ValueError(f"geometry {geometry!r}: emb_dim must exceed the "
                         f"{cfg.model.num_entity_feature_dims} entity feature dims")
    return cfg.replace(model=dataclasses.replace(cfg.model, emb_dim=emb_dim,
                                                 num_heads=num_heads))


def resolve_geometry(cfg: Config, meta: Optional[dict] = None,
                     flag: Optional[str] = None, log=print) -> Config:
    """An explicit ``--geometry`` flag wins (it must agree with the geometry a
    checkpoint recorded); otherwise the checkpoint's recorded geometry is
    re-applied."""
    recorded = (meta or {}).get("geometry")
    flag = flag.strip().lower() if flag else flag
    if flag and recorded and flag != recorded:
        raise ValueError(f"--geometry {flag} conflicts with the checkpoint's recorded "
                         f"geometry {recorded}")
    want = flag or recorded
    if want and want != geometry_of(cfg):
        log(f"geometry: {want} ({'flag' if flag else 'from checkpoint meta'})")
        return apply_geometry(cfg, want)
    return cfg


def georic_fast() -> Config:
    """georic at the 256x8 geometry, trained from scratch (cannot load
    reference checkpoints); reads the same ``geo_aware_georic2`` files."""
    return dataclasses.replace(apply_geometry(georic(), "256x8"), name="georic_fast")


PRESETS = {
    "georic": georic,
    "k_georic": k_georic,
    "nytimes800k": nytimes800k,
    "georic_fast": georic_fast,
}


def get_config(name: str) -> Config:
    return PRESETS[name]()
