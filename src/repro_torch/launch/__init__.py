"""repro_torch.launch — mesh, sharding rules, specs, serve and train CLIs.

``python -m repro_torch.launch.serve`` serves RMQ batches and
``python -m repro_torch.launch.train`` trains an LM; neither is imported
here.
"""

from . import mesh, sharding, specs

__all__ = ["mesh", "sharding", "specs"]
