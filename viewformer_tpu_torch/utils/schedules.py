"""Schedule string DSL for time-varying hyperparameters (the port's own copy
of viewformer_tpu/utils/schedules.py, for the config's Schedule fields):
  "1"                      -> ConstantSchedule(1.0)
  "linear(0,1,120000)"     -> LinearSchedule(0, 1, 120000)
  "cosine(0,1,120000)"     -> CosineSchedule(0, 1, 120000)
  "warmup(cosine(0,1,120000),2000)" -> WarmupSchedule(inner, 2000)

The port evaluates a schedule on the host at a Python step number, so only
the math backend is kept: a schedule is called with an int or a float.
"""
import dataclasses
import math


class _MathBackend:
    cos = staticmethod(math.cos)
    minimum = staticmethod(min)
    maximum = staticmethod(max)

    @staticmethod
    def asfloat(x):
        return float(x)


def _get_backend(t):
    if isinstance(t, (int, float)):
        return _MathBackend()
    raise TypeError(f'a schedule takes an int or a float step, got {type(t).__name__}')


def _fmt(v):
    """Format a float without a trailing .0 so DSL strings round-trip
    ('cosine(0,1,120000)' stays itself rather than 'cosine(0.0,1.0,120000)')."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


class Schedule:
    def __call__(self, t, dtype='float32'):
        backend = _get_backend(t)
        return float(self.call(backend.asfloat(t), backend=backend))

    def call(self, t, *, backend):
        raise NotImplementedError()

    def __mul__(self, other):
        raise NotImplementedError()

    def __rmul__(self, other):
        return self.__mul__(other)

    @classmethod
    def from_str(cls, value):
        value = str(value).strip()
        for parser in (_parse_constant, _parse_linear, _parse_cosine, _parse_warmup):
            obj = parser(value)
            if obj is not None:
                return obj
        raise ValueError(f'Cannot parse schedule: {value!r}')

    def with_total_steps(self, num_total_steps):
        if not hasattr(self, 'num_total_steps') or self.num_total_steps is not None:
            return self
        return dataclasses.replace(self, num_total_steps=num_total_steps)

    def is_zero(self):
        return False

    @staticmethod
    def zero():
        return ConstantSchedule(value=0.0)


@dataclasses.dataclass(frozen=True)
class ConstantSchedule(Schedule):
    value: float

    def call(self, t, *, backend):
        return (0 * t + 1) * self.value

    def __str__(self):
        return _fmt(self.value)

    def is_zero(self):
        return self.value == 0

    def __mul__(self, other):
        if isinstance(other, (float, int)):
            return dataclasses.replace(self, value=other * self.value)
        raise ValueError(f'Type {type(other)} is not supported')


@dataclasses.dataclass(frozen=True)
class LinearSchedule(Schedule):
    initial_value: float
    final_value: float
    num_total_steps: int = None

    def call(self, t, *, backend):
        frac = backend.minimum(t / self.num_total_steps, 0 * t + 1.0)
        return self.initial_value + frac * (self.final_value - self.initial_value)

    def __str__(self):
        return f'linear({_fmt(self.initial_value)},{_fmt(self.final_value)},{self.num_total_steps})'

    def is_zero(self):
        return self.initial_value == self.final_value == 0

    def __mul__(self, other):
        if isinstance(other, (float, int)):
            return dataclasses.replace(self, initial_value=other * self.initial_value,
                                       final_value=other * self.final_value)
        raise ValueError(f'Type {type(other)} is not supported')


@dataclasses.dataclass(frozen=True)
class CosineSchedule(Schedule):
    initial_value: float
    final_value: float
    num_total_steps: int = None

    def call(self, t, *, backend):
        frac = backend.minimum(0 * t + 1.0, t / self.num_total_steps)
        return self.final_value + (self.initial_value - self.final_value) * 0.5 * (
            backend.cos(frac * math.pi) + 1)

    def __str__(self):
        return f'cosine({_fmt(self.initial_value)},{_fmt(self.final_value)},{self.num_total_steps})'

    def is_zero(self):
        return self.initial_value == self.final_value == 0

    def __mul__(self, other):
        if isinstance(other, (float, int)):
            return dataclasses.replace(self, initial_value=other * self.initial_value,
                                       final_value=other * self.final_value)
        raise ValueError(f'Type {type(other)} is not supported')


@dataclasses.dataclass(frozen=True)
class WarmupSchedule(Schedule):
    inner: Schedule
    warmup_steps: int

    def call(self, t, *, backend):
        warmup_time = backend.minimum(t, 0 * t + self.warmup_steps)
        rest_time = backend.maximum(t - self.warmup_steps, 0 * t)
        return (warmup_time / self.warmup_steps) * self.inner.call(rest_time, backend=backend)

    def is_zero(self):
        return self.inner.is_zero()

    def __str__(self):
        return f'warmup({str(self.inner)},{self.warmup_steps})'

    def __mul__(self, other):
        return dataclasses.replace(self, inner=self.inner * other)


def _parse_constant(value):
    try:
        return ConstantSchedule(value=float(value))
    except (TypeError, ValueError):
        return None


def _parse_args3(value, name, cls):
    if not value.startswith(f'{name}(') or not value.endswith(')'):
        return None
    parts = [x.strip() for x in value[len(name) + 1:-1].split(',')]
    if len(parts) not in (2, 3):
        return None
    initial, final = float(parts[0]), float(parts[1])
    total = int(parts[2]) if len(parts) == 3 and parts[2] not in ('None', '') else None
    return cls(initial_value=initial, final_value=final, num_total_steps=total)


def _parse_linear(value):
    return _parse_args3(value, 'linear', LinearSchedule)


def _parse_cosine(value):
    return _parse_args3(value, 'cosine', CosineSchedule)


def _parse_warmup(value):
    if not value.startswith('warmup(') or not value.endswith(')') or ',' not in value:
        return None
    body = value[len('warmup('):-1]
    splitter = body.rindex(',')
    inner_str, wsteps = body[:splitter].strip(), body[splitter + 1:].strip()
    inner = Schedule.from_str(inner_str)
    return WarmupSchedule(inner=inner, warmup_steps=int(wsteps))
