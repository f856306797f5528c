"""Data parallelism over processes, one card a process: the port of the JAX
package's ``parallel/`` for its data-parallel half (`mesh`, `multihost`).
Tensor parallelism, sequence parallelism and the sharded beam search are
not ported yet (ROADMAP Queue 1 item 13b)."""
