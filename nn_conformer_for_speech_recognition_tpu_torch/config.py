"""Frozen configuration dataclasses, copied from the JAX package.

Copied rather than imported: the reference package's ``__init__`` imports
jax, which the port's machines do not have.  ``tests/test_torch_slice.py``
holds every field and default equal to the original
(`nn_conformer_for_speech_recognition_tpu/config.py`).

Dropped from the copy: ``ModelConfig.resolved_*`` (they key off
``jax.default_backend()``).  The port resolves by tensor device instead
(`resolve_compute_dtype`, `uses_attention_kernel`, `attention_route`,
`conv_route`, `uses_lstm_kernel`): on CUDA the compute dtype is bfloat16 and the
hand-written kernels run; on the CPU the compute dtype is float32 and every
kernel wrapper runs its plain PyTorch twin.  In eval mode the attention
kernel runs at every sequence length; in training `attention_route` keeps
the JAX package's switch at 768 subsampled frames
(`ATTENTION_KERNEL_MIN_T_TRAINING`), because there it decides what is
computed, not only how fast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class FeatureConfig:
    """Log-mel spectrogram extraction (librosa-style centered STFT,
    Slaney mel).  ``impl``: 'auto' or 'pallas' route through the
    hand-written STFT/log-mel kernel for a CUDA tensor; 'xla' forces the
    plain PyTorch ops on every device."""

    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 512
    win_length: Optional[int] = None  # defaults to n_fft
    n_mels: int = 40
    fmin: float = 0.0
    fmax: Optional[float] = None  # defaults to sample_rate / 2
    log_floor: float = 1e-10
    # 'minmax' | 'meanvar' | 'none'
    normalize: str = "minmax"
    htk: bool = False
    impl: str = "auto"

    @property
    def win_length_(self) -> int:
        return self.win_length or self.n_fft

    @property
    def fmax_(self) -> float:
        return self.fmax if self.fmax is not None else self.sample_rate / 2.0

    def num_frames(self, num_samples: int) -> int:
        """Number of STFT frames for a centered STFT (librosa semantics)."""
        return num_samples // self.hop_length + 1


@_frozen
class SpecAugmentConfig:
    """SpecAugment policy: W=1 time warp, F=5 frequency mask twice, T=5
    time mask with multiplicity Mt=2, optional adaptive multiplicity
    (``Mt = min(Mt, floor(pm * tau))``) and size (``T = floor(ps * tau)``)."""

    time_warp_w: int = 1
    time_warp_n: int = 1
    freq_mask_f: int = 5
    freq_mask_n: int = 2
    time_mask_t: int = 5
    time_mask_n: int = 2
    pm: float = 0.05
    ps: float = 0.05
    adaptive_multiplicity: bool = False
    adaptive_size: bool = False
    mask_value: float = 0.0


@_frozen
class SubsamplingConfig:
    """Time-preserving stride-2 conv subsampling (512 → 128 channels)."""

    channels: Tuple[int, ...] = (512, 128)
    kernel_sizes: Tuple[int, ...] = (7, 3)
    time_strides: Tuple[int, ...] = (2, 2)
    freq_strides: Tuple[int, ...] = (2, 2)

    @property
    def time_reduction(self) -> int:
        r = 1
        for s in self.time_strides:
            r *= s
        return r

    def subsampled_length(self, t: int) -> int:
        for s in self.time_strides:
            t = -(-t // s)  # ceil div: SAME padding conv with stride s
        return t


@_frozen
class ConformerConfig:
    """Conformer encoder: ½FFN → MHSA(rel-pos) → Conv → ½FFN → LN."""

    num_blocks: int = 1
    d_model: int = 512
    num_heads: int = 8
    ffn_dim: int = 512
    ffn_expansion_in_block: bool = True  # if True, ffn_dim is the hidden size
    conv_kernel_size: int = 33
    conv_expansion: int = 2  # pointwise conv expands to conv_expansion*d_model
    dropout: float = 0.5
    attention_dropout: float = 0.0
    use_relative_attention: bool = True
    # 'batchnorm' (masked) | 'groupnorm' | 'layernorm'
    conv_norm: str = "batchnorm"


@_frozen
class DecoderConfig:
    """CTC head: projection + BiLSTM + linear."""

    projection_dim: int = 256
    lstm_hidden: int = 512
    lstm_layers: int = 1
    bidirectional: bool = True
    dropout: float = 0.5


@_frozen
class ModelConfig:
    """``use_pallas`` keeps its reference name: True routes attention and
    the BiLSTM through the hand-written kernels (on a CUDA tensor), False
    runs the plain PyTorch ops everywhere.  The port's BiLSTM always owns
    the packed (kernel) parameter layout; `convert.py` packs the flax
    ``OptimizedLSTMCell`` tree into it."""

    subsampling: SubsamplingConfig = SubsamplingConfig()
    encoder: ConformerConfig = ConformerConfig()
    decoder: DecoderConfig = DecoderConfig()
    n_mels: int = 40
    # 'auto' | 'bfloat16' | 'float32'; 'auto' = bf16 on CUDA, f32 on the CPU
    compute_dtype: str = "auto"
    use_pallas: bool = False
    # 'auto' | 'flash' | 'xla'
    attention_impl: str = "auto"
    # 'auto' | 'pallas' | 'xla' for the depthwise conv of the conv module:
    # 'pallas' is the hand-written kernel with its own parameter
    # (``dw_kernel``), 'auto' and 'xla' the grouped conv1d; see `conv_route`
    conv_impl: str = "auto"
    # 'auto' | 'pallas' | 'xla'
    lstm_impl: str = "auto"
    # recompute each Conformer block in the backward pass
    # (torch.utils.checkpoint) instead of storing its activations
    remat: bool = False

    def subsampled_length(self, t: int) -> int:
        return self.subsampling.subsampled_length(t)


@_frozen
class OptimizerConfig:
    """Adafactor with a fixed learning rate, momentum (beta1) 0.9, no
    parameter scaling and no relative step, as the reference trains."""

    name: str = "adafactor"
    learning_rate: float = 2e-5
    momentum: float = 0.9
    weight_decay: float = 0.0
    clip_threshold: float = 1.0
    warmup_steps: int = 0  # 0 = constant lr (reference semantics)
    schedule: str = "constant"  # or 'transformer' (inverse-sqrt w/ warmup)


@_frozen
class MeshConfig:
    """The JAX package's logical device mesh, laid over a process group, one
    card a process (`parallel.mesh.make_mesh`): ``model_parallel_size``
    processes split each model replica (tensor parallelism), the rest are
    data ranks; ``seq_parallel`` runs Ulysses attention over the data axis
    (`parallel.sequence`); ``shard_map_kernels`` is counted only, since a
    process's kernels see its rows anyway."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1  # 1 = pure DP
    shard_map_kernels: bool = False
    seq_parallel: bool = False


@_frozen
class TrainConfig:
    batch_size: int = 32  # global batch
    epochs: int = 15
    optimizer: OptimizerConfig = OptimizerConfig()
    specaugment: SpecAugmentConfig = SpecAugmentConfig()
    use_specaugment: bool = True
    seed: int = 0
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    # also checkpoint every N steps with the data-iterator cursor (epoch,
    # step), so a mid-epoch kill resumes at the exact step (0 = per epoch)
    checkpoint_every_steps: int = 0
    # a JAX buffer-donation switch; nothing to do here, where a step updates
    # the state in place
    donate_state: bool = True
    # length bucketing; bucket boundaries in frames
    bucket_boundaries: Tuple[int, ...] = ()
    max_frames: Optional[int] = None
    # waveform gaussian-noise augmentation
    add_noise: bool = False
    noise_std: float = 0.01
    # CTC loss: 'auto' and 'pallas' are the alpha/beta kernels (their plain
    # twins on the CPU), 'xla' the plain recursion differentiated by autograd
    ctc_impl: str = "auto"
    # log per-epoch WER of the training forward's greedy decodes
    train_wer: bool = False
    # CTC prefix beam search knobs of `Trainer.evaluate(decode='beam')`
    beam: int = 8
    prune: int = 16
    max_label_len: int = 64


@_frozen
class NSTConfig:
    """Noisy Student Training loop: ft_lr 3e-6, 3 generations, 1 train
    epoch per generation, an initial supervised finetune."""

    ft_lr: float = 3e-6
    generations: int = 3
    train_epochs_per_generation: int = 1
    initial_supervised_finetune: bool = True
    # pseudo-label filtering
    unk_tolerance: float = 0.3
    max_target_len: Optional[int] = None
    add_noise: bool = False  # gaussian-noise augmentation of the retrain
    noise_std: float = 0.01


@_frozen
class PretrainConfig:
    """wav2vec-2.0-style contrastive pretraining (`models/pretrain.py`)."""

    learning_rate: float = 3e-5
    epochs: int = 100
    mask_probability: float = 0.065
    mask_value: float = 0.0
    target_dim: int = 320  # the BiLSTM decoder's output width: H = target_dim // 2
    distractors_k: int = 5
    temperature: float = 0.1
    diversity_alpha: float = 0.1
    use_gumbel_quantizer: bool = False
    gumbel_tau: float = 2.0


@_frozen
class LMConfig:
    """Transformer encoder-decoder LM over pronunciation→word streams
    (`models/lm.py`)."""

    vocab_size: int = 256
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    embed_dim: int = 320
    num_heads: int = 8
    ffn_dim: int = 512
    max_len: int = 20
    dropout: float = 0.1
    epochs: int = 3
    ngram: int = 2  # shallow-fusion context


def resolve_compute_dtype(config: ModelConfig, device: torch.device) -> torch.dtype:
    """bfloat16 on CUDA and float32 on the CPU for 'auto'; explicit values
    are honoured on every device."""
    if config.compute_dtype == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    if config.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(
            f"compute_dtype must be 'auto', 'bfloat16' or 'float32', "
            f"got {config.compute_dtype!r}"
        )
    return getattr(torch, config.compute_dtype)


def uses_attention_kernel(config: ModelConfig) -> bool:
    """True when the config lets attention go through the rel-pos flash
    kernel wrappers (always in eval mode; in training see
    `attention_route`); never without relative positions, whose attention
    has no kernel in either package."""
    return (config.use_pallas and config.attention_impl in ("auto", "flash")
            and config.encoder.use_relative_attention)


# In training the two attention routes compute different things: the einsum
# route drops attention probabilities, the kernel route (as the JAX
# package's flash path) drops the attention output only.  The JAX package
# resolves attention_impl='auto' to its flash kernels from 768 subsampled
# frames on (its FLASH_ATTENTION_MIN_T), so the port switches at the same
# length: one config must train the same model in both packages.  It is not
# a claim about which route is faster on a GPU.
ATTENTION_KERNEL_MIN_T_TRAINING = 768


def attention_route(config: ModelConfig, training: bool, t: int) -> str:
    """'kernel' (the rel-pos flash kernels, forward and backward) or
    'einsum' (the plain rel-pos attention, differentiated by autograd) for
    a sequence of ``t`` subsampled frames.

    Eval mode follows `uses_attention_kernel`: the kernel at every length
    (no dropout there, so both routes give the same result).  Training:
    ``attention_impl='xla'`` or ``use_pallas=False`` → einsum; 'flash' →
    kernel at every length; 'auto' → kernel where
    ``t >= ATTENTION_KERNEL_MIN_T_TRAINING``, einsum below.
    """
    if not uses_attention_kernel(config):
        return "einsum"
    if training and config.attention_impl == "auto" and t < ATTENTION_KERNEL_MIN_T_TRAINING:
        return "einsum"
    return "kernel"


def conv_route(config: ModelConfig) -> str:
    """'kernel' (the hand-written depthwise conv, parameter ``dw_kernel``
    (K, C)) or 'library' (the grouped ``conv1d``, parameter
    ``depthwise.weight``).  The JAX package's rule: the kernel only for
    ``use_pallas=True`` with ``conv_impl='pallas'``; 'auto' is the library
    route.  It does not depend on shapes: the two routes own different
    parameters, so the choice fixes a checkpoint's names."""
    if config.conv_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"conv_impl must be 'auto', 'pallas' or 'xla', got {config.conv_impl!r}")
    return "kernel" if config.use_pallas and config.conv_impl == "pallas" else "library"


def uses_lstm_kernel(config: ModelConfig) -> bool:
    return config.use_pallas and config.lstm_impl in ("auto", "pallas")


def conformer_s(**overrides) -> ModelConfig:
    """~10M param Conformer-S."""
    enc = ConformerConfig(
        num_blocks=4, d_model=256, num_heads=4, ffn_dim=1024,
        conv_kernel_size=33, dropout=0.1,
    )
    dec = DecoderConfig(projection_dim=256, lstm_hidden=320, dropout=0.1)
    return ModelConfig(encoder=enc, decoder=dec, **overrides)


def conformer_m(**overrides) -> ModelConfig:
    """Conformer-M, 16 blocks."""
    enc = ConformerConfig(
        num_blocks=16, d_model=256, num_heads=4, ffn_dim=1024,
        conv_kernel_size=33, dropout=0.1,
    )
    dec = DecoderConfig(projection_dim=256, lstm_hidden=320, dropout=0.1)
    return ModelConfig(encoder=enc, decoder=dec, **overrides)


def conformer_l(**overrides) -> ModelConfig:
    """~100M param Conformer-L."""
    enc = ConformerConfig(
        num_blocks=17, d_model=512, num_heads=8, ffn_dim=2048,
        conv_kernel_size=33, dropout=0.1,
    )
    dec = DecoderConfig(projection_dim=512, lstm_hidden=640, dropout=0.1)
    return ModelConfig(encoder=enc, decoder=dec, **overrides)


def reference_parity(**overrides) -> ModelConfig:
    """The reference's active config, which is the dataclasses' defaults:
    1 block, d=512, 8 heads, k=33, dropout .5."""
    return ModelConfig(**overrides)


MODEL_PRESETS = {
    "reference": reference_parity,
    "conformer_s": conformer_s,
    "conformer_m": conformer_m,
    "conformer_l": conformer_l,
}
