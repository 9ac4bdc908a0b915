"""Host-side runtime of the port: restartable batch jobs
(:mod:`.batchjob`). The native decode pipeline is shared with the JAX
package (:mod:`popsift_tpu.runtime.native`, which loads no jax)."""
