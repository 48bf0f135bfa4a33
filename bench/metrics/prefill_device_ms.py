"""Mean device time of a monolithic admission's prefill and pool write, in
ms: the ``device_ms`` of the engine's ``serve.prefill.device`` spans that
ended in the window, each from a pair of CUDA events around the prefill and
the write, read after the first token's transfer."""


def read(run):
    spans = run.window_spans("serve.prefill.device") if run.spans is not None else []
    device = [args["device_ms"] for _, _, _, args in spans if "device_ms" in args]
    return sum(device) / len(device) if device else None
