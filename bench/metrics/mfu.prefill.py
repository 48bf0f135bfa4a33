"""The counted FLOPs (the configuration's reference module's) of the
prefills whose ``serve.prefill`` span ended in the window, over those spans'
time and the H100's bf16 peak, in percent."""

from harness import work


def read(run):
    spans = run.window_spans("serve.prefill") if run.spans is not None else []
    if not spans:
        return None
    reqs = run.loop.requests
    flops = sum(run.arch.prefill_flops(run.model, reqs[args["uid"]].prompt_len)
                for _, _, _, args in spans)
    seconds = sum(end - start for _, start, end, _ in spans)
    return 100.0 * flops / seconds / work.PEAK_FLOPS
