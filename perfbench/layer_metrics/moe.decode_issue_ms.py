"""Host milliseconds a decode step spends issuing its MoE layers: the
program's ``moe.route`` and ``moe.experts`` spans inside ``serve.decode``
over the decode spans, in the traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    route = per("moe.route", "serve.decode", under="serve.decode")
    experts = per("moe.experts", "serve.decode", under="serve.decode")
    if route is None or experts is None or not route + experts:
        return None
    return route + experts
