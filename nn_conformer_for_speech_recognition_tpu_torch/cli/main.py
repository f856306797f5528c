"""Command-line interface, port of
`nn_conformer_for_speech_recognition_tpu/cli/main.py`: the same subcommands
(``prepare-data``, ``train``, ``eval``, ``nst``, ``pretrain``, ``parity``,
``benchmark``), the same flags and the same printed JSON, plus ``--device
{cuda,cpu}`` (default ``cuda``: the first CUDA device, and an error where
there is none).

    python -m nn_conformer_for_speech_recognition_tpu_torch.cli.main train \
        --manifest-dir data/manifests --model conformer_s --epochs 15

``pretrain`` trains `models.pretrain.PretrainModel` on the unlabelled
split as the JAX command does: it reads ``--model``, ``--n-mels``,
``--sample-rate``, ``--lr``, ``--batch-size``, ``--bucket-boundaries``,
``--epochs``, ``--save`` and ``--device``, and, as there, no other data or
model flag (the model is float32 on its own routes).

``train``, ``eval``, ``nst`` and ``pretrain`` run over several processes,
one card a process, under ``torchrun``:

    torchrun --standalone --nproc-per-node 8 -m \
        nn_conformer_for_speech_recognition_tpu_torch.cli.main train \
        --model-parallel 2 ...

Each process joins the group (`parallel.mesh.initialize_multihost`), the
processes are laid out as ``('data', 'model')`` from ``--model-parallel``
(tensor parallelism), ``--seq-parallel`` (Ulysses over the data axis) and
``--shard-map-kernels`` (`parallel.mesh`, `config.MeshConfig`), and only
rank 0 prints the result line and writes files.

``benchmark`` raises ``NotImplementedError``: the port's benchmark on the
H100 is ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict


def _common_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--manifest-dir", required=True,
                   help="directory containing {train,validation,test,unlabeled}.tsv")
    p.add_argument("--vocab", default="word", choices=["word", "wordpiece"])
    p.add_argument("--vocab-path", default=None,
                   help="load instead of building from train transcripts")
    p.add_argument("--ntokens", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--max-target-len", type=int, default=32)
    p.add_argument("--bucket-boundaries", type=int, nargs="*", default=None,
                   help="bucket boundaries in samples; default = one bucket at max")
    p.add_argument("--streaming", action="store_true",
                   help="960h-scale streaming pipeline: no RAM audio cache, "
                        "background decode pool + bounded batch queue")
    p.add_argument("--max-frames", type=int, default=None,
                   help="drop utterances longer than this many feature frames")


def _common_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="conformer_s",
                   choices=["reference", "conformer_s", "conformer_m", "conformer_l"])
    p.add_argument("--compute-dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="auto = bfloat16 on a CUDA device, float32 on the CPU")
    p.add_argument("--use-pallas", action="store_true",
                   help="route attention and the BiLSTM through the "
                        "hand-written CUDA kernels (their plain PyTorch "
                        "versions on the CPU)")
    p.add_argument("--ctc-impl", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor parallelism: processes a model replica is "
                        "split over (FFN hidden units, attention heads)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="Ulysses sequence parallelism: attention's heads "
                        "exchanged over the data mesh axis")
    p.add_argument("--shard-map-kernels", action="store_true",
                   help="the JAX package's per-device kernel wrapping; each "
                        "process's kernels see its rows anyway, and the "
                        "field's engagement is counted")
    p.add_argument("--n-mels", type=int, default=40)
    p.add_argument("--checkpoint", default=None, help="restore full state")
    p.add_argument("--encoder-checkpoint", default=None,
                   help="restore encoder params only (pretraining transfer)")
    _device_arg(p)


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda = the first CUDA device (an error where there "
                        "is none); cpu = the kernels' plain PyTorch versions")


def _mesh_config(args):
    """The layout's flags, as the JAX command line reads them."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C

    return C.MeshConfig(
        model_parallel_size=args.model_parallel,
        seq_parallel=getattr(args, "seq_parallel", False),
        shard_map_kernels=getattr(args, "shard_map_kernels", False),
    )


def _rank0() -> bool:
    """Rank 0 under ``torchrun``, or the only process: the one that prints
    and writes files."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import is_main_process

    return is_main_process()


def _print_result(obj) -> None:
    if _rank0():
        print(json.dumps(obj))


def _build(args):
    """Shared setup: configs, vocab, datasets, trainer.  Under ``torchrun``
    the process joins the group first."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import initialize_multihost

    initialize_multihost(args.device)
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
        BucketedDataset, load_manifest)
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import (
        build_vocab, load_any_vocab)
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    feat_cfg = C.FeatureConfig(sample_rate=args.sample_rate, n_mels=args.n_mels)
    manifests: Dict[str, list] = {}
    for split in ("train", "validation", "test", "unlabeled"):
        path = os.path.join(args.manifest_dir, f"{split}.tsv")
        if os.path.exists(path):
            manifests[split] = load_manifest(path)
    if args.vocab_path:
        vocab = load_any_vocab(args.vocab_path, args.ntokens)
    else:
        vocab = build_vocab(
            args.vocab,
            [u.transcript for u in manifests.get("train", []) if u.labeled],
            args.ntokens,
        )

    train_cfg = C.TrainConfig(
        batch_size=args.batch_size,
        optimizer=C.OptimizerConfig(learning_rate=getattr(args, "lr", 2e-5)),
        use_specaugment=not getattr(args, "no_specaugment", False),
        ctc_impl=getattr(args, "ctc_impl", "auto"),
        bucket_boundaries=tuple(args.bucket_boundaries or ()),
        max_frames=args.max_frames,
        checkpoint_dir=getattr(args, "checkpoint_dir", None),
        checkpoint_every_steps=getattr(args, "checkpoint_every_steps", 0),
        train_wer=getattr(args, "train_wer", False),
        beam=getattr(args, "beam", 8),
        prune=getattr(args, "prune", 16),
        max_label_len=getattr(args, "max_label_len", 64),
    )
    # max_frames (feature frames) → waveform samples for the dataset filter
    max_samples = (
        train_cfg.max_frames * feat_cfg.hop_length
        if train_cfg.max_frames is not None else None
    )
    dataset_cls = BucketedDataset
    if getattr(args, "streaming", False):
        # 960h-scale path: no RAM cache, producer pool + bounded queue
        from nn_conformer_for_speech_recognition_tpu_torch.data.streaming import StreamingDataset

        dataset_cls = StreamingDataset

    def _mk(utts):
        return dataset_cls(
            utts, vocab, args.batch_size, sample_rate=args.sample_rate,
            bucket_boundaries=train_cfg.bucket_boundaries,
            max_samples=max_samples,
            max_target_len=args.max_target_len,
        )

    datasets = {split: _mk(utts) for split, utts in manifests.items()}

    mcfg = C.MODEL_PRESETS[args.model](
        compute_dtype=args.compute_dtype, use_pallas=args.use_pallas,
        n_mels=args.n_mels,
    )
    model = ConformerCTC(mcfg, vocab_size=len(vocab))
    trainer = Trainer(model, vocab, feat_cfg, train_cfg, _mesh_config(args), device=args.device)
    trainer.init_state(seed=getattr(args, "seed", 0))
    if args.checkpoint:
        trainer.load(args.checkpoint)
    elif args.encoder_checkpoint:
        trainer.load_encoder_only(args.encoder_checkpoint)
    return trainer, datasets, vocab


def cmd_prepare_data(args) -> int:
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
        librispeech_manifests, speechcommands_manifests)

    if args.layout == "speechcommands":
        m = speechcommands_manifests(args.root, args.out,
                                     unlabeled_fraction=args.unlabeled_fraction)
    else:
        m = librispeech_manifests(args.root, args.out, args.splits)
    print(json.dumps({k: v for k, v in m.items()}))
    return 0


def cmd_train(args) -> int:
    trainer, datasets, vocab = _build(args)
    if getattr(args, "resume", False):
        if not args.checkpoint_dir:
            print("--resume requires --checkpoint-dir", file=sys.stderr)
            return 2
        trainer.resume(datasets["train"], args.epochs,
                       val_dataset=datasets.get("validation"))
    else:
        trainer.train(datasets["train"], args.epochs,
                      val_dataset=datasets.get("validation"))
    if args.save:
        trainer.save(args.save)
    if args.plots and _rank0():
        from nn_conformer_for_speech_recognition_tpu_torch.train.evals import plot_curves

        plot_curves(trainer.history, os.path.join(args.plots, "curves.pdf"))
    return 0


def cmd_eval(args) -> int:
    trainer, datasets, vocab = _build(args)
    split = datasets[args.split]
    dump = os.path.join(args.results_dir, "pred_tgt.txt") if args.results_dir else None
    # one inference pass: the heatmap reuses evaluate's decodes
    loss, wer, refs, hyps = trainer.evaluate(
        split, dump_path=dump, decode=args.decode, return_texts=True
    )
    _print_result({"split": args.split, "loss": loss, "wer": 100 * wer,
                   "decode": args.decode})
    if args.heatmap and args.results_dir and _rank0():
        from nn_conformer_for_speech_recognition_tpu_torch.train.evals import confusion_heatmap

        labels = [t for t in vocab.tokens[3:]]
        confusion_heatmap(refs, hyps, labels,
                          os.path.join(args.results_dir, "confusion.png"))
        confusion_heatmap(refs, hyps, labels,
                          os.path.join(args.results_dir, "confusion_pct.png"),
                          normalize=True)
    return 0


def cmd_nst(args) -> int:
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.nst.driver import run_nst

    args.lr = args.ft_lr  # NST runs at the finetune lr
    trainer, datasets, vocab = _build(args)
    nst_cfg = C.NSTConfig(
        ft_lr=args.ft_lr, generations=args.generations,
        train_epochs_per_generation=args.gen_epochs,
        max_target_len=args.max_target_len,
    )
    manager = None
    if getattr(args, "checkpoint_dir", None):
        from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import (
            CheckpointManager,
        )

        manager = CheckpointManager(args.checkpoint_dir)
    if getattr(args, "resume", False) and manager is None:
        print("--resume requires --checkpoint-dir", file=sys.stderr)
        return 2
    results = run_nst(trainer, datasets["train"], datasets["unlabeled"], nst_cfg,
                      val_dataset=datasets.get("validation"),
                      work_dir=args.work_dir,
                      checkpoint_manager=manager,
                      resume=getattr(args, "resume", False))
    _print_result([dataclasses.asdict(r) for r in results])
    return 0


def cmd_pretrain(args) -> int:
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import initialize_multihost

    initialize_multihost(args.device)
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
        BucketedDataset, load_manifest)
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu_torch.train.pretrain_loop import (
        PretrainTrainer)

    feat_cfg = C.FeatureConfig(sample_rate=args.sample_rate, n_mels=args.n_mels)
    mcfg = C.MODEL_PRESETS[args.model](n_mels=args.n_mels)
    pcfg = C.PretrainConfig(learning_rate=args.lr)
    vocab = WordVocab(["<blank>", "<pad>", "<unk>"])
    utts = load_manifest(os.path.join(args.manifest_dir, "unlabeled.tsv"))
    ds = BucketedDataset(utts, vocab, args.batch_size,
                         sample_rate=args.sample_rate,
                         bucket_boundaries=args.bucket_boundaries or ())
    tr = PretrainTrainer(mcfg, pcfg, feat_cfg, _mesh_config(args), device=args.device)
    tr.init_state(seed=0)
    tr.train(ds, args.epochs)
    if args.save:
        tr.save(args.save)
    return 0


def cmd_parity(args) -> int:
    """Reference-protocol WER parity runs: ``--protocol speechcommands``
    reproduces the reference's Base + NST table; ``--protocol librispeech``
    runs the word-piece protocol: unk-tolerance filtering, beam decode, WER
    per NST generation."""
    from nn_conformer_for_speech_recognition_tpu_torch.parity import (
        run_parity,
        run_parity_librispeech,
    )

    manifest_dir = args.manifest_dir
    if args.speechcommands_dir:
        from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
            speechcommands_manifests,
        )

        manifest_dir = os.path.join(args.work_dir, "manifests")
        speechcommands_manifests(args.speechcommands_dir, manifest_dir)
    if args.librispeech_dir:
        from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
            librispeech_manifests,
        )

        manifest_dir = os.path.join(args.work_dir, "manifests")
        librispeech_manifests(args.librispeech_dir, manifest_dir,
                              args.librispeech_splits)
    overrides = {}
    if args.tiny:  # a model small enough for a CPU smoke run
        from nn_conformer_for_speech_recognition_tpu_torch import config as C

        overrides = dict(
            encoder=C.ConformerConfig(num_blocks=1, d_model=32, num_heads=2,
                                      ffn_dim=64, conv_kernel_size=7,
                                      dropout=0.0),
            decoder=C.DecoderConfig(projection_dim=16, lstm_hidden=16,
                                    dropout=0.0),
            n_mels=args.n_mels,
        )
    if args.protocol == "librispeech":
        kw = {}
        if args.reference_vocab:  # else: the committed reference default
            kw["reference_vocab"] = args.reference_vocab
        results = run_parity_librispeech(
            manifest_dir, args.work_dir,
            epochs=args.epochs, generations=args.generations,
            batch_size=args.batch_size, max_target_len=args.max_target_len,
            unk_tolerance=args.unk_tolerance,
            beam=args.beam, prune=args.prune,
            model="conformer_m" if not args.tiny else "conformer_s",
            model_overrides=overrides,
            device=args.device,
            **kw,
        )
    else:
        results = run_parity(
            manifest_dir, args.work_dir,
            epochs=args.epochs, generations=args.generations,
            batch_size=args.batch_size, max_target_len=args.max_target_len,
            model_overrides=overrides,
            streaming=args.streaming,
            device=args.device,
        )
    print(json.dumps(results))
    return 0


def cmd_benchmark(args) -> int:
    raise NotImplementedError(
        "benchmark is not ported yet: ROADMAP Queue 1 item 9, the port's benchmark on the H100 "
        "(chip_smoke.py at the repository's root drives and times the port meanwhile)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nn_conformer_for_speech_recognition_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("prepare-data", help="build manifests from a dataset directory")
    sp.add_argument("--layout", choices=["speechcommands", "librispeech"], required=True)
    sp.add_argument("--root", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--unlabeled-fraction", type=float, default=0.25)
    sp.add_argument("--splits", nargs="*", default=["train-clean-100", "dev-clean"])
    sp.set_defaults(fn=cmd_prepare_data)

    sp = sub.add_parser("train", help="supervised CTC training")
    _common_data_args(sp)
    _common_model_args(sp)
    sp.add_argument("--epochs", type=int, default=15)
    sp.add_argument("--lr", type=float, default=2e-5)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--no-specaugment", action="store_true")
    sp.add_argument("--save", default=None)
    sp.add_argument("--plots", default=None)
    sp.add_argument("--checkpoint-dir", default=None,
                    help="write rotating per-epoch checkpoints here")
    sp.add_argument("--checkpoint-every-steps", type=int, default=0,
                    help="also write mid-epoch checkpoints with a resume "
                         "cursor every N steps")
    sp.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in "
                         "--checkpoint-dir (incl. mid-epoch cursors)")
    sp.add_argument("--train-wer", action="store_true",
                    help="log per-epoch train WER")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="evaluate a split")
    _common_data_args(sp)
    _common_model_args(sp)
    sp.add_argument("--split", default="test")
    sp.add_argument("--results-dir", default=None)
    sp.add_argument("--heatmap", action="store_true")
    sp.add_argument("--decode", default="greedy", choices=["greedy", "beam"],
                    help="beam = batched CTC prefix beam search on the device")
    sp.add_argument("--beam", type=int, default=8)
    sp.add_argument("--prune", type=int, default=16,
                    help="per-frame candidate tokens considered by the beam")
    sp.add_argument("--max-label-len", type=int, default=64)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("nst", help="noisy student training generations")
    _common_data_args(sp)
    _common_model_args(sp)
    sp.add_argument("--ft-lr", type=float, default=3e-6)
    sp.add_argument("--generations", type=int, default=3)
    sp.add_argument("--gen-epochs", type=int, default=1)
    sp.add_argument("--work-dir", default="nst_work")
    sp.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint every retrain epoch (and every "
                         "--checkpoint-every-steps steps) for NST resume")
    sp.add_argument("--checkpoint-every-steps", type=int, default=0)
    sp.add_argument("--resume", action="store_true",
                    help="resume a killed NST run exactly (mid-finetune, "
                         "mid-generation, or at a generation boundary)")
    sp.set_defaults(fn=cmd_nst)

    sp = sub.add_parser("pretrain", help="wav2vec-style contrastive pretraining")
    _common_data_args(sp)
    _common_model_args(sp)
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--lr", type=float, default=3e-5)
    sp.add_argument("--save", default=None)
    sp.set_defaults(fn=cmd_pretrain)

    sp = sub.add_parser(
        "parity",
        help="reference-protocol WER parity: Base + NST vs BASELINE.md table "
             "(speechcommands) or WER-per-NST-generation with beam decode + "
             "word pieces (librispeech)",
    )
    sp.add_argument("--protocol", default="speechcommands",
                    choices=["speechcommands", "librispeech"])
    sp.add_argument("--manifest-dir", default=None,
                    help="prepared manifests (train/validation/test/unlabeled)")
    sp.add_argument("--speechcommands-dir", default=None,
                    help="raw SpeechCommands directory (manifests built here)")
    sp.add_argument("--librispeech-dir", default=None,
                    help="raw LibriSpeech root (manifests built here)")
    sp.add_argument("--librispeech-splits", nargs="*",
                    default=["train-clean-100", "dev-clean", "test-clean"])
    sp.add_argument("--work-dir", required=True)
    sp.add_argument("--epochs", type=int, default=15)
    sp.add_argument("--generations", type=int, default=3)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--max-target-len", type=int, default=4)
    sp.add_argument("--unk-tolerance", type=float, default=0.3,
                    help="librispeech: max unk ratio of a transcript")
    sp.add_argument("--beam", type=int, default=8)
    sp.add_argument("--prune", type=int, default=16)
    sp.add_argument("--reference-vocab", default=None,
                    help="librispeech: committed word-piece vocab to load "
                         "and round-trip-assert (default: reference/vocabs/"
                         "wmp_vocab.txt under this repository's root, when "
                         "present; else an inventory is learned)")
    sp.add_argument("--n-mels", type=int, default=40)
    sp.add_argument("--tiny", action="store_true",
                    help="tiny model (synthetic-corpus smoke run)")
    sp.add_argument("--streaming", action="store_true",
                    help="speechcommands: stream train/unlabeled/mix splits "
                         "(no RAM audio cache — reference-scale corpora)")
    _device_arg(sp)
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("benchmark", help="the port's benchmark (not ported yet)")
    sp.set_defaults(fn=cmd_benchmark)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import process_group_active

    had_group = process_group_active()
    try:
        return args.fn(args)
    finally:  # leave a group this command joined
        if process_group_active() and not had_group:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
