"""Continuous-batching scheduler: the host-side request lifecycle.

Counterpart of ``deepspeed_tpu/inference/scheduler.py``. The device side is
shape-static; all dynamic serving behaviour lives here: a bounded FIFO
queue, admission of queued requests into free slots at step boundaries, a
``prefilling`` phase that walks a cursor through the prompt
``prefill_chunk`` tokens at a time, and completion bookkeeping.

Phases: ``queued -> prefilling -> decoding -> done``. Host offload
(``swapped``), disaggregated handoff and adoption, deadlines, cancellation,
recovery requeue and trace spans come with later slices; the entry points
that would start them raise NotImplementedError.
"""

import collections
import itertools
import time

# Ceiling on the retry_after_s hint (a cold completions window would
# otherwise give an absurd estimate).
RETRY_AFTER_CAP_S = 60.0


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the queue holds ``max_queue`` requests.
    Carries ``queue_depth`` and a ``retry_after_s`` hint from the recent
    completions rate (None before two completions), clamped to
    [0, RETRY_AFTER_CAP_S]."""

    def __init__(self, message, queue_depth=None, retry_after_s=None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class Request(object):
    """One generation request and its accumulated output."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature", "top_k",
                 "eos_token_id", "seed", "spec", "tokens", "slot", "phase",
                 "cursor", "submit_time", "admit_time", "first_token_time",
                 "finish_time")

    def __init__(self, rid, prompt, max_new_tokens, temperature, top_k,
                 eos_token_id, seed, spec=False):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.seed = seed
        # Speculates in the decode lane: the slot's ``spec`` field, which
        # vetoes draft agreement when False. A decode step may then emit
        # 1..spec_k+1 tokens for the slot.
        self.spec = spec
        self.tokens = []
        self.slot = None
        self.phase = "queued"
        # Prompt tokens consumed so far.
        self.cursor = 0
        self.submit_time = time.time()
        self.admit_time = None
        self.first_token_time = None
        self.finish_time = None

    @property
    def done(self):
        return self.finish_time is not None


class Scheduler(object):
    """FIFO admission over a fixed slot set."""

    def __init__(self, num_slots, max_queue):
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.queue = collections.deque()
        self.running = {}           # slot -> Request (prefilling | decoding)
        self.completed = {}         # rid -> Request
        self._ids = itertools.count()
        self._finish_times = collections.deque(maxlen=32)

    def retry_after_s(self):
        """Seconds until one queue position plausibly frees, from the
        recent completions rate; None below two completions."""
        times = self._finish_times
        if len(times) < 2 or times[-1] <= times[0]:
            return None
        rate = (len(times) - 1) / (times[-1] - times[0])
        return round(min(max(1.0 / rate, 0.0), RETRY_AFTER_CAP_S), 4)

    def submit(self, prompt, max_new_tokens, temperature, top_k,
               eos_token_id, seed, spec=False):
        if len(self.queue) >= self.max_queue:
            hint = self.retry_after_s()
            raise QueueFull(
                "inference queue is full ({} pending); retry later or raise "
                "inference.max_queue".format(len(self.queue)),
                queue_depth=len(self.queue), retry_after_s=hint)
        req = Request(next(self._ids), prompt, max_new_tokens, temperature,
                      top_k, eos_token_id, seed, spec)
        self.queue.append(req)
        return req

    def free_slot_ids(self):
        return [s for s in range(self.num_slots) if s not in self.running]

    def admissions(self, gate=None):
        """FIFO: pop (request, slot) pairs for every free slot while the
        queue lasts, moving each request into ``prefilling``. Called only
        at step boundaries.

        ``gate``: optional callable(Request) -> bool consulted on the queue
        HEAD before it pops (the paged engine's page reservation). A refused
        head ENDS the round (strict FIFO: younger requests must not jump a
        head that is waiting for pages to free)."""
        pairs = []
        for slot in self.free_slot_ids():
            if not self.queue:
                break
            if gate is not None and not gate(self.queue[0]):
                break
            req = self.queue.popleft()
            req.slot = slot
            req.phase = "prefilling"
            req.cursor = 0
            req.admit_time = time.time()
            self.running[slot] = req
            pairs.append((req, slot))
        return pairs

    def next_prefill(self):
        """The prefilling request whose next prompt chunk rides the coming
        step: FIFO by admission (rid) order; None when none prefills."""
        pf = [r for r in self.running.values() if r.phase == "prefilling"]
        return min(pf, key=lambda r: r.rid) if pf else None

    def advance_prefill(self, req, n):
        """Record ``n`` prompt tokens consumed; True when the prompt is
        exhausted (its first token was sampled this step and it moves to
        ``decoding``)."""
        req.cursor += n
        if req.cursor >= req.prompt.size:
            req.phase = "decoding"
            return True
        return False

    def complete(self, slot):
        """Evict ``slot``: its request is finished and the slot is free for
        the next admission round."""
        req = self.running.pop(slot)
        req.finish_time = time.time()
        req.phase = "done"
        req.slot = None
        self.completed[req.rid] = req
        self._finish_times.append(req.finish_time)
        return req

    def swap_out(self, req):
        raise NotImplementedError("host offload comes with the KV hierarchy "
                                  "slice (ROADMAP Queue 1)")

    def swap_in(self, req, slot):
        raise NotImplementedError("host offload comes with the KV hierarchy "
                                  "slice (ROADMAP Queue 1)")

    def begin_handoff(self, req):
        raise NotImplementedError("disaggregated handoff comes with the "
                                  "reliability and fleet slice (ROADMAP "
                                  "Queue 1)")

    def adopt(self, *args, **kwargs):
        raise NotImplementedError("disaggregated handoff comes with the "
                                  "reliability and fleet slice (ROADMAP "
                                  "Queue 1)")

    @property
    def idle(self):
        return not self.queue and not self.running

    def occupancy(self):
        return len(self.running) / float(self.num_slots)
