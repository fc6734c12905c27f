"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``, ported whole: it
is host arithmetic. Schedulers write ``optimizer.param_groups[i]['lr']``
(and OneCycle the betas); the engine reads the group at each step.
Schedulable "optimizers" are any object exposing ``param_groups``.
"""

import argparse
import logging
import math

logger = logging.getLogger(__name__)

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

EDGE_VALUE = "edge_value"
MID_VALUE = "mid_value"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"

CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"

TOTAL_NUM_STEPS = "total_num_steps"


def add_tuning_arguments(parser):
    """Add LR-schedule tuning args to an argparse parser (reference :54-153)."""
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")

    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")

    # LR range test
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001,
                       help="Starting lr value.")
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0,
                       help="scaling rate for LR range test.")
    group.add_argument("--lr_range_test_step_size", type=int, default=1000,
                       help="training steps per LR change.")
    group.add_argument("--lr_range_test_staircase", type=bool, default=False,
                       help="use staircase scaling for LR range test.")

    # OneCycle
    group.add_argument("--cycle_first_step_size", type=int, default=1000,
                       help="size of first step of 1Cycle schedule (training steps).")
    group.add_argument("--cycle_first_stair_count", type=int, default=-1,
                       help="first stair count for 1Cycle schedule.")
    group.add_argument("--cycle_second_step_size", type=int, default=-1,
                       help="size of second step of 1Cycle schedule (default first_step_size).")
    group.add_argument("--cycle_second_stair_count", type=int, default=-1,
                       help="second stair count for 1Cycle schedule.")
    group.add_argument("--decay_step_size", type=int, default=1000,
                       help="size of intervals for applying post cycle decay (training steps).")
    group.add_argument("--cycle_min_lr", type=float, default=0.01,
                       help="1Cycle LR lower bound.")
    group.add_argument("--cycle_max_lr", type=float, default=0.1,
                       help="1Cycle LR upper bound.")
    group.add_argument("--decay_lr_rate", type=float, default=0.0,
                       help="post cycle LR decay rate.")
    group.add_argument("--cycle_momentum", default=False, action="store_true",
                       help="Enable 1Cycle momentum schedule.")
    group.add_argument("--cycle_min_mom", type=float, default=0.8,
                       help="1Cycle momentum lower bound.")
    group.add_argument("--cycle_max_mom", type=float, default=0.9,
                       help="1Cycle momentum upper bound.")
    group.add_argument("--decay_mom_rate", type=float, default=0.0,
                       help="post cycle momentum decay rate.")

    # Warmup
    group.add_argument("--warmup_min_lr", type=float, default=0,
                       help="WarmupLR minimum/initial LR value.")
    group.add_argument("--warmup_max_lr", type=float, default=0.001,
                       help="WarmupLR maximum LR value.")
    group.add_argument("--warmup_num_steps", type=int, default=1000,
                       help="WarmupLR step count for LR warmup.")
    return parser


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    lr_sched_args, unknown_args = parser.parse_known_args()
    return lr_sched_args, unknown_args


def override_lr_range_test_params(args, params):
    if hasattr(args, LR_RANGE_TEST_MIN_LR) and args.lr_range_test_min_lr is not None:
        params[LR_RANGE_TEST_MIN_LR] = args.lr_range_test_min_lr
    if hasattr(args, LR_RANGE_TEST_STEP_RATE) and args.lr_range_test_step_rate is not None:
        params[LR_RANGE_TEST_STEP_RATE] = args.lr_range_test_step_rate
    if hasattr(args, LR_RANGE_TEST_STEP_SIZE) and args.lr_range_test_step_size is not None:
        params[LR_RANGE_TEST_STEP_SIZE] = args.lr_range_test_step_size
    if hasattr(args, LR_RANGE_TEST_STAIRCASE) and args.lr_range_test_staircase is not None:
        params[LR_RANGE_TEST_STAIRCASE] = args.lr_range_test_staircase


def override_1cycle_params(args, params):
    for key in (CYCLE_FIRST_STEP_SIZE, CYCLE_FIRST_STAIR_COUNT,
                CYCLE_SECOND_STEP_SIZE, CYCLE_SECOND_STAIR_COUNT,
                DECAY_STEP_SIZE, CYCLE_MIN_LR, CYCLE_MAX_LR, DECAY_LR_RATE,
                CYCLE_MIN_MOM, CYCLE_MAX_MOM, DECAY_MOM_RATE):
        if hasattr(args, key) and getattr(args, key) is not None:
            params[key] = getattr(args, key)


def override_warmup_params(args, params):
    for key in (WARMUP_MIN_LR, WARMUP_MAX_LR, WARMUP_NUM_STEPS):
        if hasattr(args, key) and getattr(args, key) is not None:
            params[key] = getattr(args, key)


def override_params(args, params):
    override_lr_range_test_params(args, params)
    override_1cycle_params(args, params)
    override_warmup_params(args, params)


def get_config_from_args(args):
    if not hasattr(args, LR_SCHEDULE) or args.lr_schedule is None:
        return None, "--{} not specified on command line".format(LR_SCHEDULE)
    if args.lr_schedule not in VALID_LR_SCHEDULES:
        return None, "{} is not supported LR schedule".format(args.lr_schedule)

    config = {"type": args.lr_schedule, "params": {}}
    if args.lr_schedule == LR_RANGE_TEST:
        override_lr_range_test_params(args, config["params"])
    elif args.lr_schedule == ONE_CYCLE:
        override_1cycle_params(args, config["params"])
    else:
        override_warmup_params(args, config["params"])
    return config, None


def get_lr_from_config(config):
    if "type" not in config:
        return None, "LR schedule type not defined in config"
    if "params" not in config:
        return None, "LR schedule params not defined in config"
    lr_schedule = config["type"]
    lr_params = config["params"]
    if lr_schedule not in VALID_LR_SCHEDULES:
        return None, "{} is not a valid LR schedule".format(lr_schedule)
    if lr_schedule == LR_RANGE_TEST:
        return lr_params[LR_RANGE_TEST_MIN_LR], ""
    if lr_schedule == ONE_CYCLE:
        return lr_params[CYCLE_MAX_LR], ""
    return lr_params[WARMUP_MAX_LR], ""


def get_schedulable_optimizer(optimizer):
    """Return an object exposing ``param_groups`` (unwrap fp16/ZeRO wrappers)."""
    if hasattr(optimizer, "param_groups"):
        return optimizer
    if hasattr(optimizer, "optimizer") and hasattr(optimizer.optimizer, "param_groups"):
        return optimizer.optimizer
    raise TypeError("{} does not expose param_groups".format(
        type(optimizer).__name__))


class LRRangeTest(object):
    """LR range test policy: lr = min_lr * (1 + step_rate * interval(t)).

    Reference lr_schedules.py:301-407.
    """

    def __init__(self,
                 optimizer,
                 lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False,
                 last_batch_iteration=-1):
        self.optimizer = get_schedulable_optimizer(optimizer)

        if isinstance(lr_range_test_min_lr, (list, tuple)):
            if len(lr_range_test_min_lr) != len(self.optimizer.param_groups):
                raise ValueError("expected {} lr_range_test_min_lr, got {}".format(
                    len(self.optimizer.param_groups), len(lr_range_test_min_lr)))
            self.min_lr = list(lr_range_test_min_lr)
        else:
            self.min_lr = [lr_range_test_min_lr] * len(self.optimizer.param_groups)

        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.last_batch_iteration = last_batch_iteration
        self.staircase = lr_range_test_staircase
        self.interval_fn = (self._staircase_interval if lr_range_test_staircase
                            else self._continuous_interval)

        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)

    def _staircase_interval(self):
        return math.floor(float(self.last_batch_iteration + 1) / self.step_size)

    def _continuous_interval(self):
        return float(self.last_batch_iteration + 1) / self.step_size

    def _get_increase(self):
        return 1 + self.step_rate * self.interval_fn()

    def get_lr(self):
        lr_increase = self._get_increase()
        return [lr * lr_increase for lr in self.min_lr]

    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        for param_group, lr in zip(self.optimizer.param_groups, group_lrs):
            param_group["lr"] = lr

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class OneCycle(object):
    """1Cycle policy: triangular lr cycle (+inverse momentum cycle), then decay.

    Reference lr_schedules.py:408-676.
    """

    def __init__(self,
                 optimizer,
                 cycle_min_lr,
                 cycle_max_lr,
                 decay_lr_rate=0.0,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 cycle_momentum=True,
                 cycle_min_mom=0.8,
                 cycle_max_mom=0.9,
                 decay_mom_rate=0.0,
                 last_batch_iteration=-1):
        self.optimizer = get_schedulable_optimizer(optimizer)

        # Cycle shape
        cycle_first_step_size = float(cycle_first_step_size)
        cycle_second_step_size = (float(cycle_second_step_size)
                                  if cycle_second_step_size is not None
                                  else cycle_first_step_size)
        self.total_size = cycle_first_step_size + cycle_second_step_size
        self.step_ratio = cycle_first_step_size / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count
                                   if cycle_second_stair_count is None
                                   else cycle_second_stair_count)
        self.decay_step_size = decay_step_size

        # LR cycle
        self.min_lrs = [cycle_min_lr] * len(self.optimizer.param_groups)
        if last_batch_iteration == -1:
            for lr, group in zip(self.min_lrs, self.optimizer.param_groups):
                group["lr"] = lr
        self.max_lrs = [cycle_max_lr] * len(self.optimizer.param_groups)
        self.decay_lr_rate = decay_lr_rate

        # Momentum cycle (only when the optimizer supports betas)
        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            supports_momentum = any("betas" in group
                                    for group in self.optimizer.param_groups)
            if not supports_momentum:
                logger.warning(
                    "cycle_momentum is disabled because optimizer {} does not "
                    "support momentum (no betas in param_groups)".format(
                        type(self.optimizer).__name__))
                self.cycle_momentum = False
            else:
                self.decay_mom_rate = decay_mom_rate
                self.min_moms = [(cycle_min_mom, 0.99)] * len(self.optimizer.param_groups)
                self.max_moms = [(cycle_max_mom, 0.99)] * len(self.optimizer.param_groups)
                if last_batch_iteration == -1:
                    for momentum, group in zip(self.min_moms,
                                               self.optimizer.param_groups):
                        group["betas"] = momentum

        self.last_batch_iteration = last_batch_iteration

    def _get_scale_factor(self):
        batch_iteration = self.last_batch_iteration + 1
        cycle = math.floor(1 + batch_iteration / self.total_size)
        x = 1.0 + batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            return x / self.step_ratio
        return (x - 1) / (self.step_ratio - 1)

    def _get_cycle_mom(self):
        scale_factor = self._get_scale_factor()
        momentums = []
        for base_betas, max_betas in zip(self.min_moms, self.max_moms):
            cycle_min_mom = base_betas[0]
            cycle_max_mom = max_betas[0]
            base_height = (cycle_max_mom - cycle_min_mom) * scale_factor
            momentums.append((cycle_max_mom - base_height, base_betas[1]))
        return momentums

    def _get_cycle_lr(self):
        scale_factor = self._get_scale_factor()
        lrs = []
        for cycle_min_lr, cycle_max_lr in zip(self.min_lrs, self.max_lrs):
            base_height = (cycle_max_lr - cycle_min_lr) * scale_factor
            lrs.append(cycle_min_lr + base_height)
        return lrs

    def _get_decay_mom(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        mom_decay_factor = 1 + self.decay_mom_rate * decay_interval
        return [(beta0 * mom_decay_factor, beta1) for beta0, beta1 in self.max_moms]

    def _get_decay_lr(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        lr_decay_factor = 1 + self.decay_lr_rate * decay_interval
        return [cycle_min_lr / lr_decay_factor for cycle_min_lr in self.min_lrs]

    def get_lr(self):
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size + 1)

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_mom()
        return self._get_decay_mom(self.last_batch_iteration - self.total_size + 1)

    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        for param_group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            param_group["lr"] = lr
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]
        if self.cycle_momentum:
            momentums = self.get_mom()
            for param_group, momentum in zip(self.optimizer.param_groups, momentums):
                param_group["betas"] = momentum

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(object):
    """Log-warmup from min_lr to max_lr over warmup_num_steps, then hold.

    Reference lr_schedules.py:677-760.
    """

    def __init__(self,
                 optimizer,
                 warmup_min_lr=0.0,
                 warmup_max_lr=0.001,
                 warmup_num_steps=1000,
                 last_batch_iteration=-1):
        self.optimizer = get_schedulable_optimizer(optimizer)
        self.min_lrs = self._format_param(self.optimizer, warmup_min_lr, "min_lr")
        self.max_lrs = self._format_param(self.optimizer, warmup_max_lr, "max_lr")
        self.delta_lrs = [big - small for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = warmup_num_steps
        self.inverse_log_warm_up = 1.0 / math.log(warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning(
                "Attempting to get learning rate from scheduler before it has started")
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta_lr * gamma)
                for min_lr, delta_lr in zip(self.min_lrs, self.delta_lrs)]

    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        for param_group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            param_group["lr"] = lr
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
        return 1.0

    def _format_param(self, optimizer, param_value, param_name):
        if isinstance(param_value, (list, tuple)):
            if len(param_value) != len(optimizer.param_groups):
                raise ValueError("expected {} value for {}, got {}".format(
                    len(optimizer.param_groups), param_name, param_value))
            return list(param_value)
        return [param_value] * len(optimizer.param_groups)


class WarmupDecayLR(WarmupLR):
    """WarmupLR followed by linear decay to zero over total_num_steps.

    Reference lr_schedules.py:761-809.
    """

    def __init__(self,
                 optimizer,
                 total_num_steps,
                 warmup_min_lr=0.0,
                 warmup_max_lr=0.001,
                 warmup_num_steps=1000,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super(WarmupDecayLR, self).__init__(optimizer,
                                            warmup_min_lr,
                                            warmup_max_lr,
                                            warmup_num_steps,
                                            last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning("total_num_steps {} is less than warmup_num_steps {}".format(
                total_num_steps, warmup_num_steps))

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
        return max(
            0.0,
            float(self.total_num_steps - self.last_batch_iteration) /
            float(max(1.0, self.total_num_steps - self.warmup_num_steps)))
