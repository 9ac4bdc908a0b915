"""Host-side runtime of the port: restartable batch jobs
(:mod:`.batchjob`) and the native decode pipeline
(:mod:`.native`, built from native/popsift_host.cpp by :mod:`.build`)."""
