"""Distribution utilities: path-based parameter, batch and cache partitioning
(the port of ``repro.dist``)."""
