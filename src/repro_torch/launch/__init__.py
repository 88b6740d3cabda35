"""Entry points: the serving entry point (``serve``) and the per-cluster
serving example (``serve_cluster_models``)."""
