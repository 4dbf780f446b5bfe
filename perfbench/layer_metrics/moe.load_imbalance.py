"""How unevenly the router loads the experts this card holds: the rows
the busiest held expert computed over the mean held expert's, summed
over every MoE layer and step of the traced window (the program's
``moe.expert_rows`` counter, read once after the window); 1 is even."""


def read(out, ctx):
    rows = out.readings.get("expert_rows")
    if not rows or not sum(rows):
        return None
    return max(rows) * len(rows) / sum(rows)
