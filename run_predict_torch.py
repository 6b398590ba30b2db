"""Predict with the PyTorch/CUDA port (the flags of run_predict.py).

python run_predict_torch.py --image_dir demo/ --save_dir out/ --cropped_images
python run_predict_torch.py --image_dir photos/ --save_dir out/ --batch_size 8 --no_vis
python run_predict_torch.py ... --device cpu      # plain versions, no card
"""

from hierarchicalprobabilistic3dhuman_torch.cli.predict import main

if __name__ == "__main__":
    main()
