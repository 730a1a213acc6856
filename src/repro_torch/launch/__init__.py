"""repro_torch.launch — mesh, sharding rules, specs, roofline, dry run,
serve and train CLIs.

``python -m repro_torch.launch.serve`` serves RMQ batches,
``python -m repro_torch.launch.train`` trains an LM and
``python -m repro_torch.launch.dryrun`` plans every (arch × shape) cell on
the ``meta`` device; none of the three is imported here.
"""

from . import mesh, roofline, sharding, specs

__all__ = ["mesh", "roofline", "sharding", "specs"]
