"""Command-line tools of the port, run as modules:
``python -m orientedobjectdetection_torch.tools.<name>`` with ``train``,
``test``, ``generate_synth``, ``img_split``, ``tiled_eval_demo``,
``serve``, ``confusion_matrix``, ``get_flops``, ``browse_dataset``,
``heatmap``, ``image_demo``, ``huge_image_demo`` and ``image_demo_timed``.
Several processes train with ``python -m torch.distributed.run
--nproc_per_node N -m orientedobjectdetection_torch.tools.train``.
"""
