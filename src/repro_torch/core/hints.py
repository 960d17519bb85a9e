"""Ingress routing hints (paper §4.2.2).

Modern orchestration frameworks already parse incoming event payloads to
route requests. Nexus's ingress layer promotes deterministic data
dependencies found in the trigger event (target bucket/key/size) into
RPC metadata headers *before* the invocation reaches the worker node —
zero user-code changes. 96% of surveyed functions have such
deterministic inputs; the rest take the streaming fallback.

An event may declare any number of inputs and outputs (scatter-gather,
fan-out): `extract_hints` returns them in declaration order, which is
also the handler's program order for matching against the workload's
`IOProfile`. Only the *first* hinted input is prefetched at ingress —
later GETs are guest-issued and already overlap nothing.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, Sequence


@dataclass(frozen=True)
class InputHint:
    bucket: str
    key: str
    size_bytes: int | None       # None -> size opaque (streaming fallback)
    cacheable: bool = True       # False -> opted out of SharedCache

    @property
    def prefetchable(self) -> bool:
        return self.size_bytes is not None


@dataclass(frozen=True)
class OutputHint:
    bucket: str
    key: str


def _input_from(d: dict) -> InputHint | None:
    if "bucket" in d and "key" in d:
        return InputHint(d["bucket"], d["key"], d.get("size"),
                         bool(d.get("cache", True)))
    return None


def _output_from(d: dict) -> OutputHint | None:
    if "bucket" in d and "key" in d:
        return OutputHint(d["bucket"], d["key"])
    return None


def extract_hints(
        event: dict | str) -> tuple[tuple[InputHint, ...],
                                    tuple[OutputHint, ...]]:
    """Parse a trigger event (S3-notification / Step-Functions style
    JSON) and promote every data dependency to metadata, in order.
    Returns ``((), ())`` for opaque events — the platform then uses the
    streaming fallback."""
    if isinstance(event, str):
        try:
            event = json.loads(event)
        except json.JSONDecodeError:
            return (), ()
    if not isinstance(event, dict):
        return (), ()

    inputs: list[InputHint] = []
    outputs: list[OutputHint] = []
    # S3 event notification shape: one input per record
    for rec in event.get("Records") or []:
        if isinstance(rec, dict) and "s3" in rec:
            s3 = rec["s3"]
            inputs.append(InputHint(
                bucket=s3["bucket"]["name"],
                key=s3["object"]["key"],
                size_bytes=s3["object"].get("size")))
    # workflow-style direct payload references (lists or single)
    for d in event.get("inputs") or []:
        hint = _input_from(d) if isinstance(d, dict) else None
        if hint is not None:
            inputs.append(hint)
    if isinstance(event.get("input"), dict):
        hint = _input_from(event["input"])
        if hint is not None:
            inputs.append(hint)
    for d in event.get("outputs") or []:
        out = _output_from(d) if isinstance(d, dict) else None
        if out is not None:
            outputs.append(out)
    if isinstance(event.get("output"), dict):
        out = _output_from(event["output"])
        if out is not None:
            outputs.append(out)
    return tuple(inputs), tuple(outputs)


def make_event(inputs: Iterable[Sequence], outputs: Iterable[Sequence]) -> dict:
    """Build a trigger event (test/benchmark helper).

    ``inputs`` is an iterable of ``(bucket, key)``,
    ``(bucket, key, size)`` or ``(bucket, key, size, cacheable)``
    tuples (size ``None`` -> opaque; cacheable ``False`` -> the
    SharedCache opt-out header); ``outputs`` of ``(bucket, key)``
    tuples.
    """
    ins = []
    for item in inputs:
        bucket, key, *rest = item
        size = rest[0] if rest else None
        cacheable = rest[1] if len(rest) > 1 else True
        ins.append({"bucket": bucket, "key": key,
                    **({"size": size} if size is not None else {}),
                    **({"cache": False} if not cacheable else {})})
    return {
        "inputs": ins,
        "outputs": [{"bucket": b, "key": k} for b, k in outputs],
    }
