"""Command-line tools of the port, run as modules:
``python -m orientedobjectdetection_torch.tools.train|test|generate_synth``.
"""
