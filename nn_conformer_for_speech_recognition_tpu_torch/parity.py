"""WER-parity harness, port of
`nn_conformer_for_speech_recognition_tpu/parity.py`: reproduces the
reference's SpeechCommands protocol end to end and emits its comparison
table, and runs the LibriSpeech protocol (word pieces, beam decode, WER per
NST generation).

The reference's published numbers (its notebook's result table):

    Base (supervised only)    val 17.02 / test 18.77
    NST (3 generations)       val 16.23 / test 18.08

Protocol reproduced here (one command: ``cli parity --manifest-dir ...``):
  * reference-parity model preset: 1 Conformer block, d=512, 8 heads,
    depthwise k=33, dropout .5;
  * features: 40 log-mels, hop 512, per-utterance MIN-MAX normalisation
    (``FeatureConfig(normalize='minmax')``);
  * word vocab with the reference's special-token head;
  * Adafactor lr 2e-5, β1=0.9, batch 32, 15 epochs with SpecAugment,
    per-epoch validation;
  * '_'-padded WER protocol (`train/metrics.padded_wer`);
  * NST: initial supervised finetune at ft_lr=3e-6 then 3 generations of
    {pseudo-label U → filter → mix → retrain 1 epoch}.

Both run on the first CUDA device unless ``device="cpu"`` is passed.  No
dataset is fetched: the tests run the harness on the synthetic corpus, and
the real comparison is one ``prepare-data`` + ``parity`` invocation away
once a dataset directory exists.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

REFERENCE_TABLE = {
    # the reference's result table (WER %, val/test)
    "base": {"val": 17.02, "test": 18.77},
    "nst": {"val": 16.23, "test": 18.08},
}

# the reference's committed vocab artifacts, looked for in a ``reference``
# directory at this repository's root and nowhere outside it; both
# protocols assert a round trip against them where they are present and
# skip it where they are not (``--reference-vocab`` names another file)
REPOSITORY_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REFERENCE_VOCABS = os.path.join(REPOSITORY_ROOT, "reference", "vocabs")
REFERENCE_WORD_VOCAB = os.path.join(_REFERENCE_VOCABS, "myvocab.txt")
REFERENCE_WPM_VOCAB = os.path.join(_REFERENCE_VOCABS, "wmp_vocab.txt")


def assert_reference_vocab_roundtrip(path: str, log=print):
    """Round-trip the COMMITTED reference vocab artifact through the port's
    tokenizers (the harnesses assert protocol fidelity against the
    artifacts, not only against vocabs rebuilt from transcripts).

    * word vocab (`vocabs/myvocab.txt`, 35 commands + specials): every
      non-special token must survive parse∘decode exactly;
    * word-piece vocab (`vocabs/wmp_vocab.txt`, 2050 pieces): segmentation
      must reuse the committed pieces: any ▁-initial piece parsed as a word
      round-trips, and piece-exact ids re-decode to the source text.
    Returns the loaded vocab, or None when the artifact is absent."""
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import (
        SPACE_MARKER,
        load_any_vocab,
    )

    if not os.path.exists(path):
        log(f"[parity] reference vocab {path} absent — round-trip skipped")
        return None
    vocab = load_any_vocab(path)
    specials = {vocab.tokens[vocab.pad_id], vocab.tokens[vocab.blank_id],
                vocab.tokens[vocab.unk_id]}
    n_checked = 0
    for tok in vocab.tokens:
        if tok in specials or not tok:
            continue
        if tok.startswith(SPACE_MARKER):  # word-initial piece ⇒ a word
            word = tok[len(SPACE_MARKER):]
            ids = vocab.parse(word)
            assert vocab.unk_id not in ids, (tok, ids)
            assert vocab.decode_ids(ids) == word, (tok, vocab.decode_ids(ids))
            n_checked += 1
        elif " " not in tok and SPACE_MARKER not in tok and "<" not in tok:
            # word-level vocab entry: must round-trip as itself
            ids = vocab.parse(tok)
            if len(ids) == 1 and ids[0] != vocab.unk_id:
                assert vocab.decode_ids(ids) == tok, tok
                n_checked += 1
    assert n_checked > 0, f"no tokens checked in {path}"
    log(f"[parity] reference vocab {os.path.basename(path)}: "
        f"{n_checked} tokens round-trip OK ({len(vocab)} total)")
    return vocab


def run_parity(
    manifest_dir: str,
    work_dir: str,
    epochs: int = 15,
    generations: int = 3,
    batch_size: int = 32,
    lr: float = 2e-5,
    ft_lr: float = 3e-6,
    max_target_len: int = 4,
    model_overrides: Optional[dict] = None,
    streaming: bool = False,
    log=print,
    device=None,
) -> Dict:
    """Run Base then NST under the reference protocol; return the table.

    ``streaming=True`` routes the big splits (train, unlabeled, and every
    NST mix) through `data/streaming.StreamingDataset` (no RAM audio cache,
    bounded-queue producers), the configuration for reference-scale corpora
    (SpeechCommands is 63,340 train clips); per-stage wall-clock and
    peak-RSS land in the returned ``stages`` dict."""
    import resource
    import time as _time

    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
        BucketedDataset,
        load_manifest,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.data.streaming import (
        StreamingDataset,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.nst.driver import run_nst
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    stages: Dict[str, Dict] = {}

    def _stage(name):
        class _S:
            def __enter__(self):
                self.t0 = _time.perf_counter()
                return self

            def __exit__(self, *exc):
                stages[name] = {
                    "wall_s": round(_time.perf_counter() - self.t0, 1),
                    "max_rss_mb": round(
                        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1
                    ),
                }
        return _S()

    os.makedirs(work_dir, exist_ok=True)
    # protocol fidelity against the committed artifact (35 commands+specials)
    assert_reference_vocab_roundtrip(REFERENCE_WORD_VOCAB, log=log)
    feat_cfg = C.FeatureConfig(normalize="minmax")  # n_mels=40, hop=512 defaults
    with _stage("load_manifests"):
        manifests = {
            s: load_manifest(os.path.join(manifest_dir, f"{s}.tsv"))
            for s in ("train", "validation", "test", "unlabeled")
            if os.path.exists(os.path.join(manifest_dir, f"{s}.tsv"))
        }
    vocab = build_vocab(
        "word", [u.transcript for u in manifests["train"] if u.labeled]
    )

    def mk(utts, big=False):
        cls = StreamingDataset if (streaming and big) else BucketedDataset
        return cls(
            utts, vocab, batch_size, max_target_len=max_target_len
        )

    with _stage("build_datasets"):
        dss = {
            s: mk(u, big=s in ("train", "unlabeled"))
            for s, u in manifests.items()
        }

    mcfg = C.reference_parity(**(model_overrides or {}))
    model = ConformerCTC(mcfg, vocab_size=len(vocab))
    train_cfg = C.TrainConfig(
        batch_size=batch_size,
        optimizer=C.OptimizerConfig(learning_rate=lr),  # Adafactor β1=.9
        use_specaugment=True,
        donate_state=False,
    )
    trainer = Trainer(model, vocab, feat_cfg, train_cfg, log_fn=log, device=device)
    trainer.init_state(seed=0)

    log(f"[parity] supervised training: {epochs} epochs")
    with _stage("supervised_train"):
        trainer.train(dss["train"], epochs, val_dataset=dss.get("validation"))
    results: Dict = {"protocol": "reference-parity", "epochs": epochs,
                     "generations": generations,
                     "streaming": streaming, "wer": {}}
    base = {}
    with _stage("base_eval"):
        for split in ("validation", "test"):
            if split in dss:
                _, w = trainer.evaluate(dss[split], wer_protocol="padded")
                base["val" if split == "validation" else "test"] = round(100 * w, 2)
    results["wer"]["base"] = base
    trainer.save(os.path.join(work_dir, "base_ckpt"))

    if generations > 0 and "unlabeled" in dss:
        log(f"[parity] NST: {generations} generations at ft_lr={ft_lr}")
        ncfg = C.NSTConfig(
            ft_lr=ft_lr, generations=generations,
            train_epochs_per_generation=1, max_target_len=max_target_len,
        )
        # the reference builds a fresh runner at ft_lr; the state it is
        # handed brings its own optimizer, in this package as in the JAX one
        nst_trainer = Trainer(
            model, vocab, feat_cfg, train_cfg, learning_rate=ft_lr, log_fn=log, device=device
        )
        nst_trainer.state = trainer.state
        with _stage("nst"):
            run_nst(nst_trainer, dss["train"], dss["unlabeled"], ncfg,
                    val_dataset=dss.get("validation"), work_dir=work_dir)
        nst = {}
        with _stage("nst_eval"):
            for split in ("validation", "test"):
                if split in dss:
                    _, w = nst_trainer.evaluate(dss[split], wer_protocol="padded")
                    nst["val" if split == "validation" else "test"] = round(100 * w, 2)
        results["wer"]["nst"] = nst
        nst_trainer.save(os.path.join(work_dir, "nst_ckpt"))

    results["stages"] = stages
    results["reference"] = REFERENCE_TABLE
    table = format_table(results)
    log(table)
    with open(os.path.join(work_dir, "parity.json"), "w") as f:
        f.write(json.dumps(results, indent=1) + "\n")
    with open(os.path.join(work_dir, "parity.md"), "w") as f:
        f.write(table + "\n")
    return results


def format_table(results: Dict) -> str:
    """The comparison table: ours beside the reference's."""
    lines = [
        "| config | val WER % (ours) | test WER % (ours) | val (reference) | test (reference) |",
        "|---|---|---|---|---|",
    ]
    for key, label in (("base", "Base (supervised)"), ("nst", "NST")):
        ours = results["wer"].get(key, {})
        ref = REFERENCE_TABLE[key]
        lines.append(
            f"| {label} | {ours.get('val', '—')} | {ours.get('test', '—')} "
            f"| {ref['val']} | {ref['test']} |"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# LibriSpeech protocol (WER per NST generation)
# ---------------------------------------------------------------------------


def run_parity_librispeech(
    manifest_dir: str,
    work_dir: str,
    epochs: int = 15,
    generations: int = 3,
    batch_size: int = 16,
    lr: float = 2e-5,
    ft_lr: float = 3e-6,
    ntokens: int = 2050,
    max_target_len: int = 128,
    unk_tolerance: float = 0.3,
    beam: int = 8,
    prune: int = 16,
    model: str = "conformer_m",
    model_overrides: Optional[dict] = None,
    reference_vocab: Optional[str] = REFERENCE_WPM_VOCAB,
    log=print,
    device=None,
) -> Dict:
    """The full LibriSpeech protocol, one command: WER on the dev and test
    splits per NST generation.

      * word-piece vocab: the reference's committed `vocabs/wmp_vocab.txt`
        (2050 pieces, `<pad>/<blank>/<unk>` head) when present, round-trip
        asserted; else a network-free BPE inventory learned from the train
        transcripts;
      * unk-tolerance + transcript-length filtering of the TRAIN split and
        of every NST pseudo-label batch (`NSTConfig.unk_tolerance`);
      * supervised training at the Adafactor lr, SpecAugment;
      * **beam-search decode** for every WER measurement (Conformer-M + beam
        + word pieces);
      * NST generations at ``ft_lr``: pseudo-label U → filter → manifest mix
        → retrain, with WER(dev) and WER(test) reported AFTER EVERY
        GENERATION: the per-generation table.

    The reference published no LibriSpeech numbers, so the comparison column
    is this package's own measurements per generation.
    """
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
        BucketedDataset,
        load_manifest,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordPieceVocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.nst.driver import run_nst
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    os.makedirs(work_dir, exist_ok=True)
    manifests = {
        s: load_manifest(os.path.join(manifest_dir, f"{s}.tsv"))
        for s in ("train", "validation", "test", "unlabeled")
        if os.path.exists(os.path.join(manifest_dir, f"{s}.tsv"))
    }

    vocab = None
    if reference_vocab:
        vocab = assert_reference_vocab_roundtrip(reference_vocab, log=log)
    if vocab is None:
        log("[parity] learning word-piece inventory from train transcripts "
            "(network-free BPE)")
        vocab = WordPieceVocab.build(
            [u.transcript for u in manifests["train"] if u.labeled], ntokens
        )
        vocab.save(os.path.join(work_dir, "wmp_vocab.txt"))
    assert isinstance(vocab, WordPieceVocab), "LibriSpeech protocol uses the word-piece vocab"

    def mk(utts, drop=False):
        return BucketedDataset(
            utts, vocab, batch_size, max_target_len=max_target_len,
            drop_untolerable=drop, unk_tol=unk_tolerance,
        )

    # train-split filtering by unk tolerance; the length cap is applied by
    # BucketedDataset.make_batch (it truncates) and, on pseudo-labels, by
    # the NST filter
    dss = {
        s: mk(u, drop=(s == "train")) for s, u in manifests.items()
    }
    n_drop = len(manifests["train"]) - len(dss["train"].utterances)
    log(f"[parity] train filter: kept {len(dss['train'].utterances)}/"
        f"{len(manifests['train'])} (unk_tol={unk_tolerance})")

    if model_overrides and "encoder" in model_overrides:
        # full-architecture override (the CLI's --tiny config) replaces the
        # preset outright; presets set encoder/decoder themselves
        mcfg = C.ModelConfig(**model_overrides)
    else:
        mcfg = C.MODEL_PRESETS[model](**(model_overrides or {}))
    train_cfg = C.TrainConfig(
        batch_size=batch_size,
        optimizer=C.OptimizerConfig(learning_rate=lr),
        use_specaugment=True,
        donate_state=False,
        beam=beam, prune=prune, max_label_len=max_target_len,
    )
    model_ = ConformerCTC(mcfg, vocab_size=len(vocab))
    trainer = Trainer(model_, vocab, C.FeatureConfig(), train_cfg, log_fn=log, device=device)
    trainer.init_state(seed=0)

    def beam_eval(tr) -> Dict[str, float]:
        out = {}
        for split, key in (("validation", "dev"), ("test", "test")):
            if split in dss:
                _, w = tr.evaluate(dss[split], decode="beam")
                out[key] = round(100 * w, 2)
        return out

    log(f"[parity-ls] supervised: {epochs} epochs, beam={beam} eval")
    trainer.train(dss["train"], epochs, val_dataset=dss.get("validation"))
    per_gen = [{"generation": "base", **beam_eval(trainer)}]
    log(f"[parity-ls] base: {per_gen[-1]}")
    trainer.save(os.path.join(work_dir, "ls_base_ckpt"))

    if generations > 0 and "unlabeled" in dss:
        nst_trainer = Trainer(model_, vocab, C.FeatureConfig(), train_cfg,
                              learning_rate=ft_lr, log_fn=log, device=device)
        nst_trainer.state = trainer.state
        for gen in range(generations):
            ncfg = C.NSTConfig(
                ft_lr=ft_lr, generations=1, train_epochs_per_generation=1,
                initial_supervised_finetune=(gen == 0),
                unk_tolerance=unk_tolerance, max_target_len=max_target_len,
            )
            res = run_nst(nst_trainer, dss["train"], dss["unlabeled"], ncfg,
                          val_dataset=dss.get("validation"),
                          work_dir=os.path.join(work_dir, f"ls_gen{gen}"))
            per_gen.append({
                "generation": gen,
                "num_pseudo_labels": res[-1].num_pseudo_labels,
                "num_kept": res[-1].num_kept,
                **beam_eval(nst_trainer),
            })
            log(f"[parity-ls] gen {gen}: {per_gen[-1]}")
        nst_trainer.save(os.path.join(work_dir, "ls_nst_ckpt"))

    results = {
        "protocol": "librispeech",
        "vocab": {"kind": "wordpiece", "size": len(vocab),
                  "source": reference_vocab if reference_vocab and
                  os.path.exists(reference_vocab or "") else "learned-bpe"},
        "epochs": epochs, "generations": generations,
        "beam": beam, "prune": prune,
        "unk_tolerance": unk_tolerance,
        "train_dropped_by_filter": n_drop,
        "wer_per_generation": per_gen,
        "reference": "none published (main.ipynb cell 49: full-scale "
                     "LibriSpeech attempt failed — SURVEY.md §6); parity "
                     "target per BASELINE.json north star",
    }
    table = format_librispeech_table(per_gen)
    log(table)
    with open(os.path.join(work_dir, "librispeech_parity.json"), "w") as f:
        f.write(json.dumps(results, indent=1) + "\n")
    with open(os.path.join(work_dir, "librispeech_parity.md"), "w") as f:
        f.write(table + "\n")
    return results


def format_librispeech_table(per_gen) -> str:
    """WER per NST generation."""
    lines = [
        "| NST generation | dev WER % | test WER % | pseudo-labels kept |",
        "|---|---|---|---|",
    ]
    for row in per_gen:
        kept = row.get("num_kept", "—")
        lines.append(
            f"| {row['generation']} | {row.get('dev', '—')} "
            f"| {row.get('test', '—')} | {kept} |"
        )
    return "\n".join(lines)
