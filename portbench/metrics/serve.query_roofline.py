"""The query's share of its roofline, in %: the least time of the prompt
constants, K3's products and the relevancy (roofline.query) over the
device time of the "query" and "relevancy" intervals' operations."""


def read(rec: dict):
    t = rec["stage_s"].get("query")
    return None if not t else 100.0 * rec["least_s"]["query"] / t
