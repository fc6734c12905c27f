"""Per-token streaming over the harvest path.

Counterpart of ``deepspeed_tpu/inference/frontdoor/stream.py``.

A TokenStream is a thin iterator over a handle's MONOTONE token list:
``FleetRequest.tokens`` never shrinks and never duplicates across
failovers (the ``_prior`` stitching in fleet.py), and the engine-local
``Request.tokens`` only appends — so a plain integer cursor is
failover-safe by construction. The stream yields exactly the tokens a
batch ``harvest()`` would return, in order, as they land: mid-stream
replica failover replays the request from its token prefix and the
cursor simply resumes where it stopped, re-emitting nothing.

The stream does not step the target itself; it calls an injected
``pump`` callable (the front door steps under its lock, or just waits
when a fleet's own replica threads are stepping) until the handle
reaches a terminal phase, then drains the tail.
"""

import time


class TokenStream(object):
    """Iterator of token ids for one in-flight request.

    Single-consumer: exactly one thread iterates a given stream (the
    usual generator contract). ``close()`` may be called from the
    consumer to cancel the underlying request early; iterating after
    close raises StopIteration.
    """

    # Consumed by exactly one thread; the handle's token list is only
    # ever read (never mutated) here, and the cursor/closed scalars
    # belong to the consumer.
    _THREAD_OWNED = frozenset({"_cursor", "_closed", "_first_seen"})

    # Phases with no further tokens coming — the scheduler Request's
    # terminal phases plus the front door's pre-dispatch verdicts.
    _TERMINAL = ("done", "cancelled", "expired", "failed")

    def __init__(self, handle, pump, poll_s=0.002, cancel=None,
                 tracer=None):
        self._handle = handle
        self._pump = pump
        self._cancel = cancel
        self._poll_s = float(poll_s)
        self._cursor = 0
        self._closed = False
        self._first_seen = False
        self._tracer = tracer
        self._trace = getattr(handle, "trace", None)

    def _mark(self, name, **args):
        """Consumer-side lifecycle instant on the front door's ring —
        stream events carry the same trace context as the rest of the
        request's hops, so the autopsy sees delivery, not just
        generation."""
        if self._tracer is None or self._trace is None:
            return
        self._tracer.instant(name, tid=self._trace.tid,
                             hop=self._trace.hop(), **args)

    # ------------------------------------------------------- iterator

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        while True:
            toks = self._handle.tokens
            if self._cursor < len(toks):
                tok = toks[self._cursor]
                self._cursor += 1
                if not self._first_seen:
                    self._first_seen = True
                    self._mark("stream/first_token")
                return tok
            # No unread token. Re-check tokens AFTER observing a
            # terminal phase — the finishing step appends the last
            # token(s) before flipping the phase, so the order
            # (phase-then-tokens) would race the other way around.
            if self._handle.phase in self._TERMINAL:
                toks = self._handle.tokens
                if self._cursor < len(toks):
                    continue
                self._closed = True
                self._mark("stream/drained", tokens=self._cursor,
                           phase=self._handle.phase)
                raise StopIteration
            made_progress = self._pump()
            if not made_progress:
                time.sleep(self._poll_s)

    # ------------------------------------------------------- control

    @property
    def phase(self):
        return self._handle.phase

    @property
    def handle(self):
        return self._handle

    def close(self):
        """Stop iterating and cancel the request if still in flight."""
        if self._closed:
            return
        self._closed = True
        self._mark("stream/closed", tokens=self._cursor)
        if self._cancel is not None and \
                self._handle.phase not in self._TERMINAL:
            self._cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
