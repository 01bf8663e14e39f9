"""Launching a job's worker processes: the worker's description
(:mod:`.env`) and the elastic watcher (:mod:`.watch`), cut to one host."""
