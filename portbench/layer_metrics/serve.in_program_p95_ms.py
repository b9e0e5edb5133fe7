"""The 95th percentile of a served request's time inside the program: from
its handler's start to its reply written (`serve.request`), over the
requests whose spans were recorded (program span)."""

from portbench.spans import percentile, serve_records


def read(r):
    got = [(e - s) / 1e6 for name, _, s, e in serve_records(r.window) or []
           if name == "serve.request"]
    return percentile(got, 0.95) if got else None
