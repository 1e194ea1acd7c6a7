"""Sharding of the port's models over a ``DeviceMesh`` (port of
``repro.parallel``): the mesh context and ``constrain`` (``ctx``), and
the DP / FSDP / TP / EP / SP rules as DTensor placements
(``sharding``)."""

from repro_torch.parallel.sharding import (param_specs, batch_specs,
                                           cache_specs, tree_shardings,
                                           comm_volumes)
