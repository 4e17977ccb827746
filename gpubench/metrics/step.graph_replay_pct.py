"""step.graph_replay_pct: the share of the window's steps that the program
ran as a replay of its captured CUDA graph, from run_pretrain's own
info["step_graph"] ('eager', 'capture' or 'replay' a step), sliced as
Context.window_step_s slices info["step_s"]. None where the program keeps
no such record, and off the card, where no step can replay."""


def read(ctx):
    modes = ctx.info.get("step_graph")
    if modes is None or not ctx.feed.on_card:
        return None
    lo = ctx.feed.warm_steps
    window = modes[lo:lo + ctx.feed.steps]
    if not window:
        return None
    return 100.0 * window.count("replay") / len(window)
