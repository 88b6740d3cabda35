"""Entry points: the training driver (``train``), the serving entry point
(``serve``), the port's first run (``quickstart``), and the examples:
EchoPFL over transformer clients with a checkpointed server
(``train_async_pfl``) and per-cluster serving (``serve_cluster_models``)."""
