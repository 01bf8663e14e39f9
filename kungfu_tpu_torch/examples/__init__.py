"""The port's counterparts of the repo's ``examples/`` scripts, runnable
as ``python -m kungfu_tpu_torch.examples.<name>``.  Each rank is a
process; run without ``--rank``, a module starts its ``--world N`` ranks
itself (:mod:`.ranks`)."""
