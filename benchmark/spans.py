"""The port's phase spans (`utils.profiling.annotate`) as the per-layer
readers see them: the span table (`utils.profiling.phase_table`), taken only
where its gate span, a leaf that runs once a step or a batch, counts the
profiled steps.  Elsewhere a reader gives None: a port without the table,
or spans recorded outside the profiled calls, or some of them missed."""

GATES = {"train": "train.optimizer", "label": "label.decode"}
UNTRACED = "host: no op recorded (Python)"  # `trace.summarise`'s label of an idle gap under no host range


def table(r, kind: str):
    try:
        from nn_conformer_for_speech_recognition_tpu_torch.utils.profiling import phase_table
    except ImportError:
        return None
    t = phase_table()
    return t if t.get(GATES[kind], (0,))[0] == r.profiled_steps else None


def _rows(r, kind: str, names):
    t = table(r, kind)
    rows = None if t is None else [t.get(n) for n in names]
    return None if rows is None or None in rows else rows


def device_ms(r, kind: str, *names: str):
    """The device time of the spans ``names`` (their CUDA event pairs, busy
    or idle), ms a step; None off the card."""
    rows = _rows(r, kind, names)
    dev = None if rows is None else [row[2] for row in rows]
    return None if dev is None or None in dev else 1e3 * sum(dev) / r.profiled_steps


def host_ms(r, kind: str, *names: str):
    """The host time of the spans ``names``, ms a step."""
    rows = _rows(r, kind, names)
    return None if rows is None else 1e3 * sum(row[1] for row in rows) / r.profiled_steps


def idle_share(r, kind: str, *labels: str):
    """The device's idle time under ``labels`` (the trace's idle gaps that
    carry them), % of the profiled span."""
    if table(r, kind) is None:
        return None
    idle = dict(r.trace.idle)
    return 100.0 * sum(idle.get(label, 0.0) for label in labels) / r.trace.span_s
