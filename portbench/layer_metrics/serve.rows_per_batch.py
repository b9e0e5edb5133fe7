"""Requests a batch of the service over the window: the change in
`ExplainService.stats`' `batched_rows` over the change in its `batches`
(program counter)."""


def read(r):
    return r.window["rows"] / r.window["batches"] if r.window.get("batches") else None
