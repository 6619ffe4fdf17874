"""The apps: the CLI and the ControlNet CLI, the PCA score visualizer, the
two Gradio demos and the condition preprocessors of the ControlNet path."""
