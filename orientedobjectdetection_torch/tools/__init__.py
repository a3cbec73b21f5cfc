"""Command-line tools of the port, run as modules:
``python -m orientedobjectdetection_torch.tools.<name>`` with ``train``,
``test``, ``generate_synth``, ``img_split``, ``tiled_eval_demo``,
``serve``, ``confusion_matrix``, ``get_flops``, ``browse_dataset``,
``heatmap``, ``image_demo``, ``huge_image_demo``, ``image_demo_timed``,
``print_config`` (a config with its bases merged), ``publish_model`` (a
checkpoint's model state alone, its hash in the name),
``convert_reference_weights`` (a reference checkpoint of the YOLO stack or
ReDet under the port's names) and ``hard_protocol`` (every
``*_hard_synth.py`` family trained in one process, with the summary).
Several processes train with ``python -m torch.distributed.run
--nproc_per_node N -m orientedobjectdetection_torch.tools.train``.
"""
