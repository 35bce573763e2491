"""Small host utilities of the port (``utils.logging.MetricLogger``)."""
