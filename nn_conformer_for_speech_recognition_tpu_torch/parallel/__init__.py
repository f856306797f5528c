"""Parallelism over processes, one card a process: the port of the JAX
package's ``parallel/``.  `mesh` lays the processes out as ``('data',
'model')`` and holds the data- and tensor-parallel collectives and the rule
table, `sequence` the Ulysses attention over the data group, `multihost`
the host-side gathers.  ``kernel_sharding`` has no counterpart: a process's
kernels see only its rows."""
