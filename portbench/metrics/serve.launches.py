"""Device operations a frame launched inside the program's spans: those of
"lsv2.render" and "lsv2.query" (a frame's two top spans), over the traced
frames' count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    s = spans.of(rec)
    if s is None or "render" not in s:
        return None
    return (s["render"]["ops"] + s.get("query", {}).get("ops", 0)) \
        / rec["calls"]
