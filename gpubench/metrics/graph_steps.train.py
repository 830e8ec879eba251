"""graph_steps.train: the share of the window's training steps that ran
as CUDA-graph replays (the group runner's `steps` counter: graph, eager,
partial). Layer: group runner. Moves train_samples_s."""


def read(ctx):
    by = ctx.window.get("steps_by_route")
    total = sum(by.values()) if by else 0
    if not total:
        return None
    return 100.0 * by["graph"] / total
