"""Mean host time of the decode tick, in ms: over the window's ticks, the
``serve.decode`` span's wall less the ``device_ms`` of the
``serve.tick.device`` span of the same ``tick`` (uploads, the launch, the
draws, the tokens' transfer, the record loop).  With ``tick_graph_ms`` it
splits the ticks ``tick_ms`` reads."""


def read(run):
    if run.spans is None:
        return None
    device = {args["tick"]: args["device_ms"]
              for _, _, _, args in run.window_spans("serve.tick.device") if "device_ms" in args}
    host = [1e3 * (end - start) - device[args["tick"]]
            for _, start, end, args in run.window_spans("serve.decode")
            if args.get("tick") in device]
    return sum(host) / len(host) if host else None
