"""Traffic kinds: ``<kind>.py`` reads the traffic files whose ``kind`` it is
(its class ``KIND``); see :mod:`portbench.workloads`."""
