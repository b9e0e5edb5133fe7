"""One driver per kind of traffic; the traffic file's `kind` names it."""
