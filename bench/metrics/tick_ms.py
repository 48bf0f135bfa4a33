"""Mean length of the engine's ``serve.decode`` spans that ended in the
window, in ms: uploads, the replayed tick graph, the draws and the tokens'
transfer to the host."""


def read(run):
    spans = run.window_spans("serve.decode") if run.spans is not None else []
    if not spans:
        return None
    return 1e3 * sum(end - start for _, start, end, _ in spans) / len(spans)
