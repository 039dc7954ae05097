"""Share of the traced window in which no kernel, copy or set ran on the
card: the window's wall time less the union of the device's intervals.
Moves ``train_step_ms``."""


def read(view):
    return view.idle_percent()
