"""enqueue_ms.served (ms): the host's time per block in
``Pipeline.process_block`` (the pinned staging copy, the host→device copy's
enqueue and the graph's ``apply`` with its launches), the mean of the
harness's spans around it in the traced window.  Moves ``msps``."""


def read(run):
    spans = run["spans"].get("enqueue_s", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
