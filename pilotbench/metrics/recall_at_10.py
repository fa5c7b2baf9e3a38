"""recall_at_10: the share of the exact 10 nearest neighbours (the plain
reference's) that the answers of the window return, over every answer."""


def read(run):
    if int(run.search.get("k", 10)) != 10 or "recall_miss" not in run.readings:
        return None
    return 1.0 - run.readings["recall_miss"]
