"""The 95th percentile of a served request's wait before its batch runs:
from its put on the queue (`serve.queue`) to the close of the batch that
took it (the end of that batch's `serve.linger`), over the requests whose
spans were recorded (program span)."""

from portbench.spans import percentile, requests, serve_records


def read(r):
    got = requests(serve_records(r.window) or [])
    return percentile([(q["closed"] - q["put"]) / 1e6 for q in got], 0.95) if got else None
