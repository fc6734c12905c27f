"""The port's pipeline schedules against the JAX package's, instruction
for instruction (``runtime/pipe/schedule.py``: pure Python, no device).

Every (schedule, stages, micro-batches, stage id) of the grid below, which
covers the cases of the JAX ``tests/unit/test_pipe_schedule.py`` (1-4
stages; 1, 3, 4, 5, 6, 8 and 10 micro-batches), must yield the same steps
of the same instructions with the same buffer ids, and the same buffer
count. Exact equality: there is no tolerance.
"""

import pytest
import torch

from deepspeed_tpu.runtime.pipe import schedule as jsched

from deepspeed_tpu_torch.runtime.pipe import schedule as tsched

torch.set_num_threads(1)

CLASSES = ("TrainSchedule", "InferenceSchedule", "DataParallelSchedule")
CASES = [(stages, micro, stage_id) for stages in (1, 2, 3, 4)
         for micro in (1, 3, 4, 5, 6, 8, 10) for stage_id in range(stages)]


def _steps(module, cls, micro, stages, stage_id):
    sched = getattr(module, cls)(micro_batches=micro, stages=stages,
                                 stage_id=stage_id)
    steps = [[(type(c).__name__, dict(c.kwargs)) for c in cmds]
             for cmds in sched]
    return steps, sched.num_pipe_buffers()


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("stages,micro,stage_id", CASES)
def test_schedule_matches_jax(cls, stages, micro, stage_id):
    got = _steps(tsched, cls, micro, stages, stage_id)
    want = _steps(jsched, cls, micro, stages, stage_id)
    assert got == want


def test_instruction_classes_and_reprs_match_jax():
    names = [n for n in dir(jsched) if isinstance(getattr(jsched, n), type)
             and issubclass(getattr(jsched, n), jsched.PipeInstruction)]
    for n in names:
        a, b = getattr(tsched, n), getattr(jsched, n)
        kw = {"buffer_id": 3} if issubclass(b, jsched.BufferOpInstruction) \
            else {}
        assert repr(a(**kw)) == repr(b(**kw))
        assert a(**kw) == a(**kw) and hash(a(**kw)) == hash(a(**kw))
    assert tsched.call_to_str("f", 1, x=2) == jsched.call_to_str("f", 1, x=2)


def test_send_recv_pair_within_steps():
    """Stage s's sends and stage s+1's receives pair up within steps, in
    the port's schedule (the property the per-rank interpreter's blocking
    transfers rely on)."""
    m, s = 4, 3
    steps = [list(tsched.TrainSchedule(micro_batches=m, stages=s,
                                       stage_id=i).steps())
             for i in range(s)]
    for step_id in range(len(steps[0])):
        for i in range(s - 1):
            sends = sum(isinstance(c, tsched.SendActivation)
                        for c in steps[i][step_id])
            recvs = sum(isinstance(c, tsched.RecvActivation)
                        for c in steps[i + 1][step_id])
            grads_out = sum(isinstance(c, tsched.SendGrad)
                            for c in steps[i + 1][step_id])
            grads_in = sum(isinstance(c, tsched.RecvGrad)
                           for c in steps[i][step_id])
            assert sends == recvs and grads_out == grads_in
