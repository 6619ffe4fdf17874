"""The ElasticDiffusion algorithm: background pads, estimators, pipeline."""
