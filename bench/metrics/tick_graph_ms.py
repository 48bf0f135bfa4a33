"""Mean device time of the decode tick's graph replay, in ms: the
``device_ms`` of the engine's ``serve.tick.device`` spans that ended in the
window, each from a pair of CUDA events recorded around the replay on its
stream and read after the tokens' transfer."""


def read(run):
    spans = run.window_spans("serve.tick.device") if run.spans is not None else []
    device = [args["device_ms"] for _, _, _, args in spans if "device_ms" in args]
    return sum(device) / len(device) if device else None
