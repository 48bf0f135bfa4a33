"""Mean length of the engine's ``serve.prefill`` spans that ended in the
window, in ms: one monolithic prefill, its pool write and its first draw's
inputs."""


def read(run):
    spans = run.window_spans("serve.prefill") if run.spans is not None else []
    if not spans:
        return None
    return 1e3 * sum(end - start for _, start, end, _ in spans) / len(spans)
