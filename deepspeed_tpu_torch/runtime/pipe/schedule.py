"""Pipeline instruction schedules: pure data, no device.

The port's own copy of the JAX package's ``runtime/pipe/schedule.py``
(itself the reference's ``runtime/pipe/schedule.py``). A schedule is a
generator of instruction lists, one list per step, for one stage; the
port's ``PipelineEngine`` interprets the stream of its own stage
(``runtime/pipe/engine.py``), so every rank runs the same instructions in
the same order as the JAX engine runs them for that stage.

The 1F1B ``TrainSchedule`` emits 2 * (micro_batches + stages - 1) steps,
forward and backward passes alternating by the parity of step and stage;
its buffer count is max(2, min(stages - stage_id + 1, micro_batches)).
"""

from abc import ABC, abstractmethod


def call_to_str(base, *args, **kwargs):
    """``base(arg, ..., key=value, ...)`` as a string."""
    name = "{}(".format(base)
    if args:
        name += ", ".join(repr(arg) for arg in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join("{}={}".format(key, repr(arg))
                          for key, arg in kwargs.items())
    name += ")"
    return name


class PipeSchedule(ABC):
    """Directs a pipeline engine by generating sequences of PipeInstruction.

    Each yielded step is atomic: a barrier can be placed between successive
    steps without deadlock.
    """

    def __init__(self, micro_batches, stages, stage_id):
        super().__init__()
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    @abstractmethod
    def steps(self):
        """Yield a list of PipeInstruction for each step in the schedule."""

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id):
        """Cyclic buffer allocation."""
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        self.it = None
        return self

    def __next__(self):
        if self.it is None:
            self.it = self.steps()
        return next(self.it)


class InferenceSchedule(PipeSchedule):
    """Pipelined inference: forward-only wavefront with double buffering
    (reference schedule.py:129-179)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id

            # Alternate send/recv buffers
            if _is_even(self.stage_id):
                recv_buf = step_id % 2
                send_buf = (step_id + 1) % 2
            else:
                recv_buf = (step_id + 1) % 2
                send_buf = step_id % 2

            if self.is_first_stage or self.is_last_stage:
                if self._valid_micro_batch(micro_batch_id):
                    cmds.append(LoadMicroBatch(recv_buf))

            if _is_even(self.stage_id):
                if self._valid_stage(self.next_stage) and \
                        self._valid_micro_batch(micro_batch_id - 1):
                    cmds.append(SendActivation(send_buf))
                if self._valid_stage(self.prev_stage) and \
                        self._valid_micro_batch(micro_batch_id):
                    cmds.append(RecvActivation(recv_buf))
            else:
                if self._valid_stage(self.prev_stage) and \
                        self._valid_micro_batch(micro_batch_id):
                    cmds.append(RecvActivation(recv_buf))
                if self._valid_stage(self.next_stage) and \
                        self._valid_micro_batch(micro_batch_id - 1):
                    cmds.append(SendActivation(send_buf))

            if self._valid_micro_batch(micro_batch_id):
                cmds.append(ForwardPass(recv_buf))

            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B-interleaved training schedule (reference schedule.py:182-290).

    Pipeline parallelism is extracted through gradient accumulation, so
    convergence matches data parallelism at the same batch size.
    """

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)

            if self._valid_micro_batch(prev_micro_batch_id):
                prev_buffer = self._buffer_idx(prev_micro_batch_id)
            if self._valid_micro_batch(micro_batch_id):
                curr_buffer = self._buffer_idx(micro_batch_id)

            cmds = []

            # Exchange activations
            if is_forward:
                if self._valid_micro_batch(micro_batch_id) and \
                        self._valid_stage(self.prev_stage):
                    cmds.append(RecvActivation(curr_buffer))
                if self._valid_micro_batch(prev_micro_batch_id) and \
                        self._valid_stage(self.prev_stage):
                    cmds.append(SendGrad(prev_buffer))
            else:
                if self._valid_micro_batch(prev_micro_batch_id) and \
                        self._valid_stage(self.next_stage):
                    cmds.append(SendActivation(prev_buffer))
                if self._valid_micro_batch(micro_batch_id) and \
                        self._valid_stage(self.next_stage):
                    cmds.append(RecvGrad(curr_buffer))

            # First/last stage loads
            if self.stage_id == 0 or self.stage_id == self.stages - 1:
                if is_forward and self._valid_micro_batch(micro_batch_id):
                    cmds.append(LoadMicroBatch(curr_buffer))

            # Computation
            if self._valid_micro_batch(micro_batch_id):
                if is_forward:
                    cmds.append(ForwardPass(curr_buffer))
                else:
                    cmds.append(BackwardPass(curr_buffer))

            # Model step at the end of the batch
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def num_pipe_buffers(self):
        """Distance from this stage to the last stage, floored at 2."""
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id):
        if _is_even(step_id) and _is_even(self.stage_id):
            return self._even_step_forward_id(step_id), True
        elif _is_odd(step_id) and _is_odd(self.stage_id):
            return self._odd_step_forward_id(step_id), True
        elif _is_even(step_id) and _is_odd(self.stage_id):
            return self._even_step_backward_id(step_id), False
        elif _is_odd(step_id) and _is_even(self.stage_id):
            return self._odd_step_backward_id(step_id), False
        else:
            raise AssertionError("unreachable")

    def _even_step_forward_id(self, step_id):
        return int(step_id // 2 - self.stage_id // 2)

    def _odd_step_forward_id(self, step_id):
        return int((step_id - 1) // 2 - self.stage_id // 2)

    def _even_step_backward_id(self, step_id):
        return int(step_id // 2 - self.stages + (self.stage_id + 1) // 2)

    def _odd_step_backward_id(self, step_id):
        return int(((step_id - 1) // 2) - self.stages + 1 + self.stage_id // 2)


class DataParallelSchedule(PipeSchedule):
    """Traditional data parallelism with gradient accumulation
    (reference schedule.py:292-315)."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [
                LoadMicroBatch(buffer_id=0),
                ForwardPass(buffer_id=0),
                BackwardPass(buffer_id=0),
            ]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1


class PipeInstruction:
    """Base class for all pipeline-engine instructions. Keyword args are
    stored as members (namedtuple-style)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        return call_to_str(self.name, **self.kwargs)

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Step the optimizer and zero gradients. Issued after ReduceGrads and
    ReduceTiedGrads; a synchronization point among data-parallel ranks."""


class ReduceGrads(PipeInstruction):
    """Reduce computed gradients among data-parallel processes in the stage."""


class ReduceTiedGrads(PipeInstruction):
    """Reduce gradients of tied modules within a pipeline-parallel group."""


class BufferOpInstruction(PipeInstruction):
    """An instruction operating on pipeline buffer ``buffer_id``."""

    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """buffers['inputs'][buffer_id] = next(data_iter)"""


class ForwardPass(BufferOpInstruction):
    """buffers['outputs'][buffer_id] = forward(buffers['inputs'][buffer_id])"""


class BackwardPass(BufferOpInstruction):
    """Backward pass from stored outputs + received output-grads."""


class SendActivation(BufferOpInstruction):
    """Send activations to the next pipeline stage (blocking pairwise)."""


class RecvActivation(BufferOpInstruction):
    """Receive activations from the previous pipeline stage."""


class SendGrad(BufferOpInstruction):
    """Send input-gradients to the previous pipeline stage."""


class RecvGrad(BufferOpInstruction):
    """Receive output-gradients from the next pipeline stage."""


def _is_even(x):
    return x % 2 == 0


def _is_odd(x):
    return x % 2 != 0
