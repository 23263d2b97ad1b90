"""Analysis of the port: Ulam / MSM ground truths (``msm``)."""
