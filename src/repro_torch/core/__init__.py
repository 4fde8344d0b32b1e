"""The paper's scheduling core: profiler, impact estimator, request
classifier, queues, priority regulator and policies."""
