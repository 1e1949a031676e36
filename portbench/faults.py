"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  A run of the command line never plants one.

* ``stale_state``: the step returns the state it was given;
* ``half_channels``: the upper half of the channels is left out (zero);
* ``even_channels``: every other channel, from channel 0, is left out;
* ``altered_answer``: one output sample of channel 3 is moved where the
  step produces it.
"""

from __future__ import annotations

FAULTS = ("stale_state", "half_channels", "even_channels", "altered_answer")


class _Faulty:
    def __init__(self, step, fault: str):
        self.step, self.fault = step, fault

    def init(self):
        return self.step.init()

    def __call__(self, state, x):
        new, y = self.step(state, x)
        if self.fault == "stale_state":
            return state, y
        if self.fault in ("half_channels", "even_channels", "altered_answer"):
            y = y.clone()
            if self.fault == "half_channels":
                y[y.shape[0] // 2:] = 0
            elif self.fault == "even_channels":
                y[0::2] = 0
            else:
                y[3, y.shape[-1] // 2] += 0.25
        return new, y


def wrap(step, fault: str | None):
    """``step`` with ``fault`` planted (None: ``step`` itself)."""
    if fault is None:
        return step
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    return _Faulty(step, fault)
