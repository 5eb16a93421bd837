from .elastic_batcher import (BatcherConfig, ElasticBatcher, Request,
                              SimEngine)

__all__ = ["BatcherConfig", "ElasticBatcher", "Request", "SimEngine"]
