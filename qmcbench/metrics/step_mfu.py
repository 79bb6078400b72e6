"""The step's counted operations (``flops.step_flops``) over the mean step
time of the window times the float32-accurate peak, in %."""


def read(ctx):
    steps = ctx['measured_step_s']
    if not steps or ctx['profile'] is None:
        return None
    flops = ctx['flops']
    seconds = sum(steps) / len(steps)
    return 100 * flops.step_flops(ctx['config'], ctx['traffic']) / (
        seconds * flops.PEAKS['f32_flops_per_s'])
