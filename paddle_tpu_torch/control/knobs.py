"""Actuated knobs: declared bounds, clamping, and slew limiting (the port of
``paddle_tpu/control/knobs.py``).

Every knob the controller may move is declared in ``KNOB_BOUNDS`` with a
hard ``min``/``max`` range and a ``slew`` limit (the largest step one
decision may take). The dict is the JAX package's LITERAL table, kept a
literal so that a static check can parse it with the stdlib AST, as
``tools/run_static_checks.py``'s ``check_control_bounds`` parses the JAX
one.

A :class:`Knob` is the only way the controller touches a live value:
``set(target)`` clamps the target into ``[min, max]``, limits the step to
``slew``, and only then calls the setter. A knob with no setter is a
*shadow* knob — it tracks the value without actuating, which is exactly
what decision replay (``controller.replay``) uses.
"""
from __future__ import annotations

__all__ = ["KNOB_BOUNDS", "Knob"]

# name -> hard bounds. ``slew`` is the max |new - old| per decision;
# ``integer`` knobs are rounded after clamping. Keep this dict a literal.
KNOB_BOUNDS = {
    "fleet.replicas":      {"min": 1,   "max": 64,     "slew": 1,
                            "integer": True},
    "fleet.hedge_after_s": {"min": 0.005, "max": 30.0, "slew": 0.25},
    "engine.chunk_size":   {"min": 8,   "max": 4096,   "slew": 256,
                            "integer": True},
    "engine.decode_burst": {"min": 1,   "max": 64,     "slew": 4,
                            "integer": True},
    "engine.max_queue":    {"min": 1,   "max": 4096,   "slew": 64,
                            "integer": True},
}


class Knob:
    """A bounded, slew-limited control variable.

    ``setter`` (optional) is called with the new value AFTER bounds and
    slew limiting; if it raises, the knob's tracked value is rolled back
    so controller state never diverges from the live system.
    """

    __slots__ = ("name", "min", "max", "slew", "integer", "value", "setter")

    def __init__(self, name, value, setter=None):
        spec = KNOB_BOUNDS.get(name)
        if spec is None:
            raise ValueError(f"undeclared knob {name!r}: every actuated "
                             "knob must have a KNOB_BOUNDS row")
        self.name = name
        self.min = spec["min"]
        self.max = spec["max"]
        self.slew = spec["slew"]
        self.integer = bool(spec.get("integer"))
        self.setter = setter
        self.value = self._quantize(min(max(value, self.min), self.max))

    def _quantize(self, v):
        return int(round(v)) if self.integer else float(v)

    def propose(self, target):
        """The value ``set(target)`` would land on: clamp to bounds, then
        limit the step from the current value to ``slew``."""
        t = min(max(target, self.min), self.max)
        lo, hi = self.value - self.slew, self.value + self.slew
        return self._quantize(min(max(t, lo), hi))

    def set(self, target):
        """Clamp + slew-limit ``target``, actuate, and return
        ``(old, new)``. ``old == new`` means the decision was a no-op."""
        old = self.value
        new = self.propose(target)
        if new == old:
            return old, old
        if self.setter is not None:
            self.setter(new)  # may raise: value stays `old`
        self.value = new
        return old, new

    def spec(self):
        return {"value": self.value, "min": self.min, "max": self.max,
                "slew": self.slew}

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Knob({self.name}={self.value} "
                f"[{self.min},{self.max}] slew={self.slew})")
