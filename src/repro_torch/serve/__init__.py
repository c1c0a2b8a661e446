"""Serving layer: the generation loop (``serve.engine``), the
``RetrievalService`` (an LM encoder over the streaming index), the
version-keyed ``ResultCache``, the ``ShapeBucketScheduler`` (per-tenant
quotas, weighted-fair drain, ``route_and_group``) and the multi-tenant
``CollectionManager``.
"""
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.collections import Collection, CollectionManager
from repro_torch.serve.engine import (generate, make_serve_prefill,
                                      make_serve_step)
from repro_torch.serve.retrieval import (RequestResult, RetrievalConfig,
                                         RetrievalService)
from repro_torch.serve.scheduler import (Request, ShapeBucketScheduler,
                                         TenantQuota, route_and_group)

__all__ = ["generate", "make_serve_prefill", "make_serve_step",
           "Collection", "CollectionManager", "Request", "RequestResult",
           "ResultCache", "RetrievalConfig", "RetrievalService",
           "ShapeBucketScheduler", "TenantQuota", "route_and_group"]
