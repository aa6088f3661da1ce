"""The pure episode-schedule functions the loader and the runner call
(``elastic.py``). The drain, retry and fault injection of the JAX
package's ``resilience/`` come with ``parallel/`` (ROADMAP Queue A)."""
