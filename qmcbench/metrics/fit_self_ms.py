"""A step's host-clock time minus its layer spans: the fit loop's own time
(host reads, statistics, monitors), per step."""


def read(ctx):
    steps = ctx['steps']
    if not steps:
        return None
    return sum(s['host_ms'] - sum(s['spans'].values()) for s in steps) / len(steps)
