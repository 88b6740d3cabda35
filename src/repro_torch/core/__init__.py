"""EchoPFL coordination: parameter plane, clustering, broadcast predictor, server."""
