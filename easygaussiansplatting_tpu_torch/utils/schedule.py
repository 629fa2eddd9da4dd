"""Learning-rate schedules.

Port of easygaussiansplatting_tpu/utils/schedule.py: the log-linear decay
with a sine-eased warm-up delay that the Gaussian positions follow. The step
is a host integer (the port's Adam keeps its count on the host), so the
schedule is evaluated in numpy float32, the precision the JAX schedule runs
at, and reading it never waits for the device.
"""

import numpy as np


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000):
    """step -> learning rate (a Python float holding a float32 value)."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda step: 0.0

    def schedule(step):
        step = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0), f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t) + np.log(f32(lr_final)) * t)
        return 0.0 if step < 0 else float(f32(delay_rate * log_lerp))

    return schedule
