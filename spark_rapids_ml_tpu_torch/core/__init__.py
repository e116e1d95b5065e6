"""Core abstractions of the port: params, estimators, data, persistence, serving."""
