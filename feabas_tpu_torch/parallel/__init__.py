"""Window solves over stacks of sections (counterpart of
``feabas_tpu/parallel``)."""
