"""Deployment descriptors of the storage service (``paper_store``)."""
